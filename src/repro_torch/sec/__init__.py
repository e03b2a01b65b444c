"""repro_torch.sec — the leakage-tiered security profiles (DESIGN.md §14).

`profiles` holds the `SecurityProfile` tiers (`perf` / `balanced` /
`hardened` / `oblivious-sketch`) that a runtime `Collection` threads into
its scheduler (batch padding) and filter backend (scan-oblivious
variants).  The leakage-measurement half of the JAX package's
`repro.sec` is not ported yet.
"""

from .profiles import (DEFAULT_PROFILE, PROFILES,  # noqa: F401
                       SECURITY_PROFILE_NAMES, SecurityProfile, get_profile)

__all__ = ["SecurityProfile", "PROFILES", "SECURITY_PROFILE_NAMES",
           "DEFAULT_PROFILE", "get_profile"]
