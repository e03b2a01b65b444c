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

A `Mesh` lays the logical devices out on named axes, row-major, as
`jax.make_mesh` does: `make_host_mesh` (every device on "data") and
`make_production_mesh` (16 x 16, or 2 x 16 x 16 with a "pod" axis) give
the reference's shapes, as data that sharding specs resolve against.

Nothing here reads an environment variable, and nothing touches a
device at import.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device

__all__ = ["local_devices", "device_count", "force_device_count", "Mesh",
           "make_mesh", "make_production_mesh", "make_host_mesh"]

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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Logical devices on named axes, row-major (the last axis fastest)."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, i: int) -> dict[str, int]:
        """Logical device i's position on each axis."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names,
                                         self.axis_sizes))):
            out[name] = i % n
            i //= n
        return {a: out[a] for a in self.axis_names}


def make_mesh(shape, axes, device=None) -> Mesh:
    """The first prod(shape) placement devices (`local_devices(device)`)
    on the named axes; raises if there are fewer."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "rank")
    devs = local_devices(device)
    need = math.prod(shape)
    if need > len(devs):
        raise ValueError(f"a {shape} mesh needs {need} devices; "
                         f"{len(devs)} are available")
    return Mesh(axes, shape, tuple(devs[:need]))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16 x 16 = 256 devices a pod; 2 pods = 512 with a leading 'pod'
    axis (the reference's TPU pod layout)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device=None) -> Mesh:
    """Every placement device on one 'data' axis."""
    return make_mesh((device_count(device),), ("data",), device)
