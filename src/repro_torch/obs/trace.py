"""Structured per-request tracing for the serving stack (DESIGN.md §13).

One `TraceRecorder` per service (or per collection): a clock-injected,
ring-buffered, thread-safe span store.  Spans form per-trace trees —
one trace per request (`request` root with `queue`/`flush`|`slot`/
`emit` children), one trace per batched engine call (`flush`/`step`
root with `filter`/`refine` children, linked to the requests that rode
it by a `batch` attribute), one trace per ingest operation.

A span opened with `child_span` feeds up to three sinks, each only
while it is active: the ambient `TraceRecorder` (the span tree), a
torch.profiler recording (a `record_function` range of the span's
name, so the span sits on the profiler's clock beside the device's
events), and the active `obs.profiler.KernelProfiler` (its span table:
the span's calls, host seconds and the synchronising CUDA calls made
inside it, apart from the kernels' device times).  A recorder span
can also carry the device interval of its work (`device_open` /
`device_close` / `device_resolve`: two CUDA events on the current
stream, read once the host has waited past them).

Three properties the rest of the repo depends on:

  * **Deterministic under `VirtualClock`** — the recorder never reads
    wall time itself; it asks the injected clock, the same instance the
    schedulers run on, so tests assert exact span trees (structure,
    attributes, and virtual timestamps) for scripted interleavings.
  * **Near-free when disabled** — nothing in the hot path allocates or
    locks when no sink is active: `child_span()` is a contextvar read,
    the profiler's enabled flag and one module-global read, returning a
    shared no-op span (no CUDA event either), and the schedulers guard
    every recording call on `tracer is not None`.
  * **No plaintext leakage** — spans carry ids, counts, byte totals,
    and backend names.  They never carry query or database ciphertext
    material (let alone plaintexts); the trace of a search is exactly
    the accounting the paper's §V-C communication model already makes
    public to the server.

Exports: Chrome-trace/Perfetto JSON (`to_chrome_trace`) and a
structured event log (`to_events`).
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from collections import deque

import torch

from . import profiler as _kprof

__all__ = ["Span", "TraceRecorder", "NullRecorder", "NULL_RECORDER",
           "child_span", "child_complete", "current"]


class Span:
    """One timed, attributed node of a trace tree.  Usable as a context
    manager when produced by `TraceRecorder.span` (closes itself and
    pops the ambient-context stack on exit)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t_start",
                 "t_end", "attrs", "_recorder", "_token", "_device")

    def __init__(self, name: str, trace_id: str, span_id: int,
                 parent_id: int | None, t_start: float,
                 t_end: float | None = None, attrs: dict | None = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = t_start
        self.t_end = t_end
        self.attrs = dict(attrs or {})
        self._recorder = None
        self._token = None
        self._device = None

    def set(self, **attrs):
        """Attach attributes after the fact (e.g. counters only known
        once the spanned work completed)."""
        self.attrs.update(attrs)
        return self

    # ------------------------------------------------- device interval

    def device_open(self, device):
        """Record a CUDA event on `device`'s current stream: the start of
        the span's device work.  A no-op off the card."""
        device = torch.device(device)
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            self._device = [stream, start, None]

    def device_close(self):
        """Record the end event, after the span's last enqueued device
        work (the span's exit records it if this was not called)."""
        if self._device is not None and self._device[2] is None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._device[0])
            self._device[2] = end

    def device_resolve(self):
        """Set the `device_s` attribute from the two events.  Call it
        only once the host has waited on work enqueued after the end
        event: it adds no synchronisation of its own."""
        if self._device is not None and self._device[2] is not None:
            _, start, end = self._device
            self.attrs["device_s"] = start.elapsed_time(end) / 1e3
            self._device = None

    @property
    def duration(self) -> float:
        return 0.0 if self.t_end is None else self.t_end - self.t_start

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "t_start": self.t_start, "t_end": self.t_end,
                "attrs": dict(self.attrs)}

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id!r}, "
                f"id={self.span_id}, parent={self.parent_id}, "
                f"[{self.t_start}, {self.t_end}], {self.attrs})")

    # -------------------------------------------------- context manager

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._recorder is not None:
            if exc is not None:
                self.attrs.setdefault("error", repr(exc))
            self.device_close()
            self._recorder._close_cm_span(self)
        return False


class _NullSpan:
    """Shared no-op span: what `child_span` hands out when no sink is
    active.  Stateless, so one instance serves every caller
    concurrently."""

    __slots__ = ()

    def set(self, **attrs):
        return self

    def device_open(self, device):
        pass

    def device_close(self):
        pass

    def device_resolve(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SinkSpan:
    """A `child_span` while torch.profiler records or a `KernelProfiler`
    is active: a `record_function` range of the span's name, the host
    seconds and synchronising CUDA calls added to the profiler's span
    table under that name, and the recorder's span (or the no-op span)
    for attributes and the tree."""

    __slots__ = ("name", "_span", "_range", "_prof", "_t0", "_syncs0")

    def __init__(self, name: str, span, profiling: bool, prof):
        self.name = name
        self._span = span
        self._range = (torch.autograd.profiler.record_function(name)
                       if profiling else None)
        self._prof = prof
        self._t0 = 0.0
        self._syncs0 = None

    def set(self, **attrs):
        self._span.set(**attrs)
        return self

    def device_open(self, device):
        self._span.device_open(device)

    def device_close(self):
        self._span.device_close()

    def device_resolve(self):
        self._span.device_resolve()

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if self._prof is not None:
            self._syncs0 = self._prof.syncs
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            syncs, s0 = self._prof.syncs, self._syncs0
            self._prof.span(self.name, time.perf_counter() - self._t0,
                            None if syncs is None or s0 is None
                            else syncs - s0)
        if self._range is not None:
            self._range.__exit__(*exc)
        return self._span.__exit__(*exc)

# Ambient (recorder, open span) for the current thread of execution —
# how the engine's filter/refine spans find the scheduler's batch span
# without threading a recorder through every signature.
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_obs_ctx", default=None)

# True while torch.profiler (or the autograd profiler) records.
_profiler_enabled = torch.autograd._profiler_enabled


def current():
    """The ambient (recorder, span) pair, or None."""
    return _CTX.get()


def child_span(name: str, **attrs):
    """Open a span in every active sink: a child of the ambient
    recorder's span, a torch.profiler range, an entry of the active
    `KernelProfiler`.  With none active, the shared no-op span (a
    contextvar read, the profiler's flag and one module-global read —
    the disabled-mode cost)."""
    ctx = _CTX.get()
    profiling = _profiler_enabled()
    prof = _kprof._ACTIVE
    if ctx is None:
        span = _NULL_SPAN
    else:
        recorder, parent = ctx
        span = recorder.span(name, trace_id=parent.trace_id, parent=parent,
                             **attrs)
    if not profiling and prof is None:
        return span
    return _SinkSpan(name, span, profiling, prof)


def child_complete(name: str, t_start: float | None = None,
                   t_end: float | None = None, **attrs):
    """Record an already-finished child span under the ambient context
    (e.g. per-shard accounting emitted after a collective completes).
    Default interval: the ambient span's start -> now."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    recorder, parent = ctx
    now = recorder._now()
    return recorder.add_span(
        name, parent.trace_id,
        parent.t_start if t_start is None else t_start,
        now if t_end is None else t_end,
        parent=parent, **attrs)


class TraceRecorder:
    """Thread-safe ring-buffered span/event recorder.

    clock: any object with `now() -> float` seconds (the runtime's
    `Clock` seam fits); None falls back to `time.monotonic`.  Pass the
    SAME clock instance the schedulers run on, so one timeline covers
    the whole request path.
    capacity: completed spans (and events) kept — oldest evicted first.
    """

    def __init__(self, clock=None, capacity: int = 8192):
        self._now = time.monotonic if clock is None else clock.now
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=int(capacity))
        self._events: deque[dict] = deque(maxlen=int(capacity))
        self._ids = itertools.count(1)
        self.enabled = True

    # ---------------------------------------------------------- writing

    def start_span(self, name: str, trace_id: str,
                   parent: Span | None = None, **attrs) -> Span:
        """Open a span; it is stored only once `end_span` closes it."""
        return Span(name, trace_id, next(self._ids),
                    None if parent is None else parent.span_id,
                    self._now(), attrs=attrs)

    def end_span(self, span: Span, **attrs) -> Span:
        if span.t_end is not None:      # idempotent: error paths may
            return span                 # race a regular close
        span.t_end = self._now()
        if attrs:
            span.attrs.update(attrs)
        with self._lock:
            self._spans.append(span)
        return span

    def add_span(self, name: str, trace_id: str, t_start: float,
                 t_end: float, parent: Span | None = None,
                 **attrs) -> Span:
        """Record a completed span retroactively (the schedulers stamp
        queue/emit intervals after the fact from clock readings they
        already took)."""
        span = Span(name, trace_id, next(self._ids),
                    None if parent is None else parent.span_id,
                    float(t_start), float(t_end), attrs)
        with self._lock:
            self._spans.append(span)
        return span

    def event(self, name: str, trace_id: str = "", **attrs) -> dict:
        ev = {"name": name, "trace_id": trace_id, "t": self._now(),
              "attrs": attrs}
        with self._lock:
            self._events.append(ev)
        return ev

    def span(self, name: str, trace_id: str, parent: Span | None = None,
             **attrs) -> Span:
        """Context-manager span: opens now, closes (and records) on
        exit, and publishes itself as the ambient context so nested
        `child_span` calls attach underneath."""
        sp = self.start_span(name, trace_id, parent=parent, **attrs)
        sp._recorder = self
        sp._token = _CTX.set((self, sp))
        return sp

    def _close_cm_span(self, span: Span):
        if span._token is not None:
            _CTX.reset(span._token)
            span._token = None
        span._recorder = None
        self.end_span(span)

    # ---------------------------------------------------------- reading

    def spans(self, trace_id: str | None = None) -> list[Span]:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def trace_ids(self) -> list[str]:
        seen: dict[str, None] = {}
        for s in self.spans():
            seen.setdefault(s.trace_id, None)
        return list(seen)

    def tree(self, trace_id: str) -> list[dict]:
        """The trace's span forest as nested dicts (children ordered by
        start time, then record order) — what tests assert exactly."""
        spans = sorted(self.spans(trace_id),
                       key=lambda s: (s.t_start, s.span_id))
        nodes = {s.span_id: {"name": s.name, "attrs": dict(s.attrs),
                             "t_start": s.t_start, "t_end": s.t_end,
                             "children": []} for s in spans}
        roots = []
        for s in spans:
            node = nodes[s.span_id]
            if s.parent_id in nodes:
                nodes[s.parent_id]["children"].append(node)
            else:
                roots.append(node)
        return roots

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._events.clear()

    # ---------------------------------------------------------- exports

    def to_events(self) -> list[dict]:
        """Structured event log: every completed span (+ instant events)
        as plain dicts, in record order."""
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
        return ([dict(s.to_dict(), kind="span") for s in spans]
                + [dict(e, kind="event") for e in events])

    def to_chrome_trace(self) -> dict:
        """Chrome-trace / Perfetto JSON: one complete ("X") event per
        span, traces mapped to tids (named via "M" metadata events),
        instant ("i") events for point events.  `json.dump` the return
        value and load it in ui.perfetto.dev or chrome://tracing."""
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
        tids: dict[str, int] = {}

        def tid(trace_id: str) -> int:
            if trace_id not in tids:
                tids[trace_id] = len(tids) + 1
            return tids[trace_id]

        out = []
        for s in spans:
            out.append({
                "name": s.name, "ph": "X", "pid": 1,
                "tid": tid(s.trace_id),
                "ts": round(s.t_start * 1e6, 3),
                "dur": round(max(0.0, s.duration) * 1e6, 3),
                "args": {k: _jsonable(v) for k, v in s.attrs.items()},
            })
        for e in events:
            out.append({
                "name": e["name"], "ph": "i", "s": "t", "pid": 1,
                "tid": tid(e["trace_id"] or "events"),
                "ts": round(e["t"] * 1e6, 3),
                "args": {k: _jsonable(v) for k, v in e["attrs"].items()},
            })
        meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": t,
                 "args": {"name": trace}} for trace, t in tids.items()]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def _jsonable(v):
    """Span attrs may carry numpy scalars; Chrome-trace args must be
    plain JSON values."""
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v
    try:
        return int(v)
    except (TypeError, ValueError):
        try:
            return float(v)
        except (TypeError, ValueError):
            return str(v)


class NullRecorder:
    """The disabled-mode recorder: the full `TraceRecorder` surface as
    no-ops.  Handy when a caller wants to thread one object through
    unconditionally; the schedulers instead skip recording entirely on
    `tracer is None`, which is cheaper still."""

    enabled = False

    def start_span(self, name, trace_id, parent=None, **attrs):
        return _NULL_SPAN

    def end_span(self, span, **attrs):
        return span

    def add_span(self, name, trace_id, t_start, t_end, parent=None,
                 **attrs):
        return _NULL_SPAN

    def event(self, name, trace_id="", **attrs):
        return None

    def span(self, name, trace_id, parent=None, **attrs):
        return _NULL_SPAN

    def spans(self, trace_id=None):
        return []

    def trace_ids(self):
        return []

    def tree(self, trace_id):
        return []

    def clear(self):
        pass

    def to_events(self):
        return []

    def to_chrome_trace(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_RECORDER = NullRecorder()
