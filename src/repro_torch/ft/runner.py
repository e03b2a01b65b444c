"""Deprecated location: the checkpoint-restart runner lives in
`repro_torch.resilience.runner` (DESIGN.md §16), on the injected
`Clock` seam.  This shim re-exports it, as `repro.ft.runner` does in
the JAX package."""

from __future__ import annotations

import warnings

from ..resilience.runner import (ResilientRunner, RetryPolicy,  # noqa: F401
                                 StragglerWatchdog)

__all__ = ["RetryPolicy", "ResilientRunner", "StragglerWatchdog"]

warnings.warn(
    "repro_torch.ft.runner is deprecated; import RetryPolicy/"
    "ResilientRunner/StragglerWatchdog from repro_torch.resilience "
    "(DESIGN.md §16)", DeprecationWarning, stacklevel=2)
