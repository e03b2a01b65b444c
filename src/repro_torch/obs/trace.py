"""Structured per-request tracing for the serving stack (DESIGN.md §13).

One `TraceRecorder` per service (or per collection): a clock-injected,
ring-buffered, thread-safe span store.  Spans form per-trace trees —
one trace per request (`request` root with `queue`/`flush`|`slot`/
`emit` children), one trace per batched engine call (`flush`/`step`
root with `filter`/`refine` children, linked to the requests that rode
it by a `batch` attribute), one trace per ingest operation.

Three properties the rest of the repo depends on:

  * **Deterministic under `VirtualClock`** — the recorder never reads
    wall time itself; it asks the injected clock, the same instance the
    schedulers run on, so tests assert exact span trees (structure,
    attributes, and virtual timestamps) for scripted interleavings.
  * **Near-free when disabled** — nothing in the hot path allocates or
    locks when no recorder is attached: `child_span()` is a single
    contextvar read returning a shared no-op span, and the schedulers
    guard every recording call on `tracer is not None`.
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

__all__ = ["Span", "TraceRecorder", "NullRecorder", "NULL_RECORDER",
           "child_span", "child_complete", "current"]


class Span:
    """One timed, attributed node of a trace tree.  Usable as a context
    manager when produced by `TraceRecorder.span` (closes itself and
    pops the ambient-context stack on exit)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t_start",
                 "t_end", "attrs", "_recorder", "_token")

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

    def set(self, **attrs):
        """Attach attributes after the fact (e.g. counters only known
        once the spanned work completed)."""
        self.attrs.update(attrs)
        return self

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
            self._recorder._close_cm_span(self)
        return False


class _NullSpan:
    """Shared no-op span: what `child_span` hands out when no recorder
    context is active.  Stateless, so one instance serves every caller
    concurrently."""

    __slots__ = ()

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

# Ambient (recorder, open span) for the current thread of execution —
# how the engine's filter/refine spans find the scheduler's batch span
# without threading a recorder through every signature.
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_obs_ctx", default=None)


def current():
    """The ambient (recorder, span) pair, or None."""
    return _CTX.get()


def child_span(name: str, **attrs):
    """Open a child span under the ambient context; a shared no-op span
    when there is none (one contextvar read — the disabled-mode cost)."""
    ctx = _CTX.get()
    if ctx is None:
        return _NULL_SPAN
    recorder, parent = ctx
    return recorder.span(name, trace_id=parent.trace_id, parent=parent,
                         **attrs)


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
