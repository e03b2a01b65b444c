"""Deprecated: `repro_torch.ft` is an alias of `repro_torch.resilience`
(DESIGN.md §16), the counterpart of `repro.ft`: an import-compatible
shim."""

from ..resilience.runner import (ResilientRunner, RetryPolicy,  # noqa: F401
                                 StragglerWatchdog)

__all__ = ["RetryPolicy", "ResilientRunner", "StragglerWatchdog"]
