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
launch gaps the host leaves between them.  The wrapper does not wait for
them: it queues the two events, and `summary()` reads the queue after
waiting once for the card, so host and device overlap as they do
unprofiled.  A call on CPU tensors is timed on the host clock.  The
positional-argument `.nbytes` sum (tensors and numpy arrays) is recorded
as bytes touched.

Spans opened with `obs.trace.child_span` while a profiler is active go
to a table of their own (`summary().spans`): the calls and host seconds
of each span name and, on a machine with a card, the synchronising CUDA
calls made while it was open.  Those are counted by PyTorch's own sync
check (`torch.cuda.set_sync_debug_mode("warn")`, on while the profiler
is active): a blocking copy to or from the card, `.item()` and the
like, a stream or device synchronisation.  Its warnings are counted and
swallowed.  PyTorch documents the check as not covering every
synchronising call (`torch.distributed`, `torch.sparse`).

A kernel wrapper may add numbers of its own to a counters table while a
profiler is active (`count`; `summary().counters`): each fused scan +
top-k' launch adds its block plan's work tiles and slot tiles.

A call made while `torch.compiler.is_compiling()` is true is passed
through unrecorded, as the JAX package skips calls whose arguments are
tracers: timing a trace would be meaningless.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
import warnings

import torch

__all__ = ["KernelProfiler", "Summary", "profile_kernels", "instrument",
           "active_profiler"]

# The single active profiler (None = disabled). One module-global read
# on the hot path; writes only via profile_kernels().
_ACTIVE: "KernelProfiler | None" = None
_ACTIVE_LOCK = threading.Lock()

# PyTorch's warning for a synchronising CUDA call in "warn" sync mode.
_SYNC_WARNING = "called a synchronizing CUDA operation"


class Summary(dict):
    """`KernelProfiler.summary()`: the kernel table, {kernel name:
    {calls, total_s, total_bytes}} (device seconds of a card call, host
    seconds of a CPU one), with the span table beside it as `.spans`,
    {span name: {calls, total_s[, syncs]}} (host seconds; `syncs` only
    where they were counted), and the counters table as `.counters`,
    {kernel name: {counter: total}}."""

    __slots__ = ("spans", "counters")

    def __init__(self, kernels, spans, counters=None):
        super().__init__(kernels)
        self.spans = spans
        self.counters = {} if counters is None else counters


class KernelProfiler:
    """Per-kernel call/time/bytes accumulator, per-kernel counters, and
    per-span calls, host seconds and synchronising CUDA calls."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, dict] = {}
        self._queue: list[tuple] = []     # (name, start, end, nbytes)
        self._spans: dict[str, dict] = {}
        self._counters: dict[str, dict] = {}
        self.syncs: int | None = None     # counted while active on a card

    def record(self, name: str, seconds: float, nbytes: int):
        with self._lock:
            self._record(name, seconds, nbytes)

    def _record(self, name, seconds, nbytes):
        s = self._stats.setdefault(
            name, {"calls": 0, "total_s": 0.0, "total_bytes": 0})
        s["calls"] += 1
        s["total_s"] += seconds
        s["total_bytes"] += nbytes

    def defer(self, name: str, start, end, nbytes: int):
        """Queue a card call's start and end CUDA events, unread until
        `summary()`."""
        with self._lock:
            self._queue.append((name, start, end, nbytes))

    def span(self, name: str, seconds: float, syncs: int | None):
        """Add one closed span: its host seconds and, where counted, the
        synchronising CUDA calls made while it was open."""
        with self._lock:
            s = self._spans.setdefault(name, {"calls": 0, "total_s": 0.0})
            s["calls"] += 1
            s["total_s"] += seconds
            if syncs is not None:
                s["syncs"] = s.get("syncs", 0) + syncs

    def count(self, name: str, **values):
        """Add `values` to kernel `name`'s counters."""
        with self._lock:
            c = self._counters.setdefault(name, {})
            for k, v in values.items():
                c[k] = c.get(k, 0) + v

    def summary(self) -> Summary:
        """Snapshot of the kernel table, the span and counters tables as
        its `.spans` and `.counters`.  Waits for the last queued card call
        to finish, then reads the queue."""
        with self._lock:
            for n, s, e, b in self._queue:
                e.synchronize()     # one stream: only the first waits long
                self._record(n, s.elapsed_time(e) / 1e3, b)
            self._queue.clear()
            return Summary({k: dict(v) for k, v in self._stats.items()},
                           {k: dict(v) for k, v in self._spans.items()},
                           {k: dict(v) for k, v in self._counters.items()})

    def reset(self):
        """Forget every count, and the queued card calls unread."""
        with self._lock:
            self._stats.clear()
            self._queue.clear()
            self._spans.clear()
            self._counters.clear()
            if self.syncs is not None:
                self.syncs = 0

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
        with _counting_syncs(prof):
            yield prof
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev


@contextlib.contextmanager
def _counting_syncs(prof: KernelProfiler):
    """On a machine with a card, count each synchronising CUDA call in
    `prof.syncs`, from PyTorch's sync check in "warn" mode; its warnings,
    and the one that turning it on gives, are swallowed, every other
    warning is shown as before."""
    if not torch.cuda.is_available():
        yield
        return
    if prof.syncs is None:
        prof.syncs = 0
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        shown = warnings.showwarning
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        warnings.filterwarnings("ignore", message="Synchronization debug")

        def count(message, category, filename, lineno, file=None,
                  line=None):
            if str(message).startswith(_SYNC_WARNING):
                prof.syncs += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = count
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)


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
        prof.defer(name, start, end, _args_nbytes(args))
        return out

    wrapper.__wrapped__ = fn
    return wrapper
