"""Opt-in timed wrappers around the kernel entry points.

Counterpart of `repro.obs.profiler`.  Each kernel family's `ops.py`
rebinds its public entry points through `instrument(name, fn)` at import
time.  The wrapper is a strict passthrough — zero recording, one
module-global read — unless a `KernelProfiler` has been activated via
`profile_kernels()`.

When active, a call whose tensor arguments lie on the card is timed with
CUDA events recorded on the device's current stream around it (the JAX
package fences with `block_until_ready` instead): the interval is the
device time from the call's first enqueued work to its last, plus any
launch gaps the host leaves between them.  A call on CPU tensors is
timed on the host clock.  The positional-argument `.nbytes` sum (tensors
and numpy arrays) is recorded as bytes touched.

A call made while `torch.compiler.is_compiling()` is true is passed
through unrecorded, as the JAX package skips calls whose arguments are
tracers: timing a trace would be meaningless.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

__all__ = ["KernelProfiler", "profile_kernels", "instrument",
           "active_profiler"]

# The single active profiler (None = disabled). One module-global read
# on the hot path; writes only via profile_kernels().
_ACTIVE: "KernelProfiler | None" = None
_ACTIVE_LOCK = threading.Lock()


class KernelProfiler:
    """Per-kernel call/time/bytes accumulator."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, dict] = {}

    def record(self, name: str, seconds: float, nbytes: int):
        with self._lock:
            s = self._stats.setdefault(
                name, {"calls": 0, "total_s": 0.0, "total_bytes": 0})
            s["calls"] += 1
            s["total_s"] += seconds
            s["total_bytes"] += nbytes

    def summary(self) -> dict[str, dict]:
        """{kernel name: {calls, total_s, total_bytes}} snapshot."""
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    def reset(self):
        with self._lock:
            self._stats.clear()

    def total_seconds(self, prefix: str = "") -> float:
        return sum(v["total_s"] for k, v in self.summary().items()
                   if k.startswith(prefix))

    def total_bytes(self, prefix: str = "") -> int:
        return sum(v["total_bytes"] for k, v in self.summary().items()
                   if k.startswith(prefix))


def active_profiler() -> KernelProfiler | None:
    return _ACTIVE


@contextlib.contextmanager
def profile_kernels(profiler: KernelProfiler | None = None):
    """Activate kernel profiling for the dynamic extent of the block.

        with profile_kernels() as prof:
            engine.search_batch(Q, T, k)
        prof.summary()  # {"l2_topk.knn": {...}, "dce_comp.refine_topk": ...}

    Not reentrant across threads by design: one global profiler keeps
    the disabled path to a single load; nested activations stack.
    """
    global _ACTIVE
    prof = profiler if profiler is not None else KernelProfiler()
    with _ACTIVE_LOCK:
        prev = _ACTIVE
        _ACTIVE = prof
    try:
        yield prof
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev


def _args_nbytes(args) -> int:
    total = 0
    for a in args:
        nb = getattr(a, "nbytes", None)
        if nb is not None:
            total += int(nb)
    return total


def _card(args) -> torch.device | None:
    """The device of the first CUDA tensor argument (tuples of tensors,
    as the graph walk's row arrays, included), else None."""
    for a in args:
        for t in (a if isinstance(a, tuple) else (a,)):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                return t.device
    return None


def instrument(name: str, fn):
    """Wrap a kernel entry point with the opt-in timer."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prof = _ACTIVE
        if prof is None or torch.compiler.is_compiling():
            return fn(*args, **kwargs)
        dev = _card(args)
        if dev is None:                   # plain versions: host clock
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            prof.record(name, time.perf_counter() - t0, _args_nbytes(args))
            return out
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn(*args, **kwargs)
        end.record(stream)
        end.synchronize()
        prof.record(name, start.elapsed_time(end) / 1e3, _args_nbytes(args))
        return out

    wrapper.__wrapped__ = fn
    return wrapper
