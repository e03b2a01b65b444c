"""Placement devices: what the port shards a collection over.

The JAX package sizes a sharded placement by `len(jax.devices())` and
simulates more devices on the host with
`XLA_FLAGS=--xla_force_host_platform_device_count=N`.  This module is
the counterpart of both:

  local_devices(device)  the placement devices: every card of the
                         process (`torch.cuda.device_count()`), or the
                         host when the caller asks for device="cpu";
  force_device_count(n)  one process-wide setting that presents n
                         logical devices instead, logical device s
                         living on real device s % n_real — so eight
                         logical shards share one H100, or the host.

Nothing here reads an environment variable, and nothing touches a
device at import.
"""

from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["local_devices", "device_count", "force_device_count"]

_forced: int | None = None


def force_device_count(n: int | None) -> None:
    """Present `n` logical placement devices from now on (None: the real
    ones again).  Process-wide, like the XLA flag it mirrors; tests
    reset it when they finish."""
    global _forced
    if n is not None and int(n) < 1:
        raise ValueError(f"device count must be >= 1, got {n}")
    _forced = None if n is None else int(n)


def _real_devices(device=None) -> list[torch.device]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def local_devices(device=None) -> list[torch.device]:
    """The placement devices, in order: logical device s is real device
    s % n_real.  `device` picks the kind (None: the cards, and raises
    without one; "cpu": the host)."""
    real = _real_devices(device)
    n = _forced if _forced is not None else len(real)
    return [real[s % len(real)] for s in range(n)]


def device_count(device=None) -> int:
    """len(local_devices(device)): what `PlacementSpec.resolve` pins a
    sharded placement's `n_shards=None` to."""
    return len(local_devices(device))
