"""Request scheduling: the `Scheduler` interface and the flush-based
dynamic micro-batcher (DESIGN.md §8, §12).

`Scheduler` owns everything both serving schedulers share — the bounded
request queue with admission control, per-request futures, parameter-
group extraction, the worker thread, close/drain semantics, and the
injected `Clock` (DESIGN.md §12: schedulers never read wall time
directly, so tests drive them on virtual time).  Two implementations:

  * `MicroBatcher` (this module) — the classic deadline/size flush:
    a flush fires when `max_batch` compatible requests wait or the
    oldest has waited `max_wait_ms`; the real batch pads up to the next
    power-of-two bucket, so arrivals map onto a handful of compiled
    executables.
  * `SlotLoop` (`slot_loop.py`) — continuous batching over one fixed
    slot table: no deadline, no buckets, one compiled shape.

Requests batch together only when their search parameters
`(k, ratio_k, ef_search)` agree (the engine's candidate and refine
shapes are specialized on them); mixed traffic is served FIFO by the
head request's parameter group.

In this package a "compiled shape" is a shape that `warmup()` has run:
the CUDA kernels are built once per source tree at their first launch
(`kernels/_build.py`) and take any shape, so the bucketing bounds the
set of shapes the card sees, and a recompile is a kernel-library build
(`telemetry.jit_cache_size`).

Admission control: when `max_queue` requests are already waiting the
submit raises `QueueFullError` instead of growing an unbounded backlog
(callers shed load or retry; the reject is counted in telemetry).
"""

from __future__ import annotations

import abc
import collections
import contextlib
import dataclasses
import threading
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np

from ...kernels.common import next_bucket
from .clock import Clock, SystemClock

__all__ = ["Scheduler", "MicroBatcher", "QueueFullError", "batch_buckets",
           "EngineRetryPolicy"]


class QueueFullError(RuntimeError):
    """Raised by submit() when the scheduler's queue is at max_queue."""


@dataclasses.dataclass(frozen=True)
class EngineRetryPolicy:
    """Per-request retry contract for engine failures (DESIGN.md §16).

    When a batched engine call raises, the batch's requests are NOT all
    failed with the batch: each is re-run individually up to
    `max_attempts` total attempts (the failed batch call counts as each
    rider's first), with `backoff_s` of scheduler-clock time between
    attempts.  A request that exhausts its attempts is quarantined —
    its future gets the last exception and it is never retried again —
    so one poison query costs its own attempts, not its batchmates'
    results, and a persistent fault cannot retry forever.

    `max_attempts=1` restores the pre-resilience behaviour (batch
    failure fails every rider, no retry).  `AssertionError` is never
    retried: parity-verification failures are deterministic bugs, not
    transient faults.
    """

    max_attempts: int = 2
    backoff_s: float = 0.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_s < 0:
            raise ValueError("backoff_s must be >= 0")


def batch_buckets(max_batch: int) -> list[int]:
    """The bucketed batch shapes: powers of two up to max_batch (plus
    max_batch itself when it is not a power of two)."""
    sizes, b = [], 1
    while b < max_batch:
        sizes.append(b)
        b <<= 1
    sizes.append(max_batch)
    return sizes


@dataclasses.dataclass(eq=False)      # identity compare: numpy fields
class _Request:                        # make generated __eq__ ambiguous
    Q: np.ndarray                 # (d,) DCPE query ciphertext
    T: np.ndarray                 # (2d+16,) DCE trapdoor
    group: tuple                  # (k, ratio_k, ef_search)
    future: Future
    t_enq: float
    want_stats: bool = False      # future resolves to (ids, flush stats)
    t_insert: float = 0.0         # slot loop: when the row entered a slot
    span: object = None           # open obs "request" span (tracing on)
    trace_id: str = ""
    n_attempts: int = 0           # engine calls this request rode (retry)


def _stats_attrs(stats) -> dict:
    """SearchStats -> span attributes (paper §V-C cost counters)."""
    return {"backend": stats.backend, "n_queries": stats.n_queries,
            "filter_dist_evals": stats.filter_dist_evals,
            "refine_comparisons": stats.refine_comparisons,
            "filter_bytes_scanned": stats.filter_bytes_scanned,
            "bytes_up": stats.bytes_up, "bytes_down": stats.bytes_down}


class Scheduler(abc.ABC):
    """Request queue + worker thread around one `run_batch` callable.

    run_batch(Q (B, d), T (B, D), k, ratio_k=..., ef_search=...) must
    return (ids (B, k), stats) — in the runtime this is the collection's
    locked `SecureSearchEngine.search_batch`.  Subclasses implement
    `_loop` (the scheduling policy) and `warmup` (which shapes to
    compile); everything client-facing lives here so both schedulers
    present one contract to the collection and the API.
    """

    kind = "abstract"

    def __init__(self, run_batch, *, max_batch: int = 32,
                 max_queue: int = 256, telemetry=None,
                 clock: Clock | None = None, name: str = "collection",
                 tracer=None, retry_policy: EngineRetryPolicy | None = None):
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.telemetry = telemetry
        self.clock = clock if clock is not None else SystemClock()
        self.name = name
        self.retry_policy = (retry_policy if retry_policy is not None
                             else EngineRetryPolicy())
        self.n_retries = 0            # individual re-run engine calls
        self.n_quarantined = 0        # requests rejected after retries
        # obs (DESIGN.md §13): a repro.obs.TraceRecorder, or None = off.
        # Every recording call below is guarded on `is not None`, so the
        # disabled path costs one attribute read per flush.
        self.tracer = tracer
        self._req_seq = 0             # request trace ids  {name}:rN
        self._batch_seq = 0           # batch  trace ids  {name}:bN / :sN
        self._pending: collections.deque[_Request] = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(
            target=self._loop, daemon=True, name=f"{self.kind}-{name}")
        self._worker.start()

    # ------------------------------------------------------------- client

    def submit(self, C_sap_q: np.ndarray, T_q: np.ndarray, k: int, *,
               ratio_k: float = 8.0, ef_search: int = 96,
               want_stats: bool = False,
               trace_id: str | None = None) -> Future:
        """Enqueue one query; resolves to its (k,) id vector — or, with
        want_stats, to (ids, SearchStats of the enclosing batched call),
        so a protocol-level caller can report the engine's uniform
        accounting (stats.n_queries tells it how many requests rode the
        same engine call).

        trace_id names the request's trace when tracing is on (a client-
        propagated id, DESIGN.md §13); None autogenerates `{name}:rN`.
        """
        req = _Request(
            Q=np.asarray(C_sap_q), T=np.asarray(T_q),
            group=(int(k), float(ratio_k), int(ef_search)),
            future=Future(), t_enq=self.clock.now(),
            want_stats=want_stats)
        with self._cv:
            if self._closed:
                raise RuntimeError(f"{self.kind} is closed")
            if len(self._pending) >= self.max_queue:
                if self.telemetry is not None:
                    self.telemetry.record_reject()
                raise QueueFullError(
                    f"queue at max_queue={self.max_queue}; shed load")
            if self.tracer is not None:
                # the root span opens at admission and closes at emit;
                # queue/flush/slot/emit children are stamped by the
                # scheduler from clock readings it takes anyway
                req.trace_id = trace_id or f"{self.name}:r{self._req_seq}"
                self._req_seq += 1
                req.span = self.tracer.start_span(
                    "request", req.trace_id, collection=self.name,
                    scheduler=self.kind, k=int(k))
            self._pending.append(req)
            if self.telemetry is not None:
                self.telemetry.record_submit(len(self._pending))
            self._cv.notify()
        return req.future

    def search(self, C_sap_q, T_q, k, *, ratio_k: float = 8.0,
               ef_search: int = 96, timeout: float | None = 30.0):
        """Synchronous single query through the scheduling path.

        A timeout *discards* the request: if it is still queued it is
        removed (freeing its admission-control slot) and its future is
        cancelled, so the scheduler never burns a batched engine call
        computing into a future nobody will read."""
        fut = self.submit(C_sap_q, T_q, k, ratio_k=ratio_k,
                          ef_search=ef_search)
        try:
            return fut.result(timeout=timeout)
        except FutureTimeoutError:
            self.discard(fut)
            raise

    def discard(self, future: Future) -> bool:
        """Withdraw a submitted request: drop it from the queue if still
        pending and cancel its future.  Returns True when the future was
        cancelled (False = it already completed; the result stands)."""
        removed = None
        with self._cv:
            for r in self._pending:
                if r.future is future:
                    removed = r
                    self._pending.remove(r)
                    break
        cancelled = future.cancel()
        if removed is not None and removed.span is not None:
            self.tracer.end_span(removed.span, cancelled=True)
        return cancelled

    @abc.abstractmethod
    def warmup(self, example_q: np.ndarray, example_t: np.ndarray,
               k: int = 10, *, ratio_k: float = 8.0, ef_search: int = 96):
        """Compile every batch shape this policy will run, bypassing the
        queue.  Call after (re)ingesting, before steady-state traffic."""

    def close(self, wait: bool = True):
        """Stop accepting requests; drain what is queued, then exit.  If
        the drain outlives the join timeout, still-queued requests get a
        RuntimeError instead of leaving their clients hung forever."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if wait:
            self._worker.join(timeout=60.0)
            if self._worker.is_alive():
                with self._cv:
                    stranded = list(self._pending)
                    self._pending = collections.deque()
                for r in stranded:
                    self._resolve(r.future, exc=RuntimeError(
                        f"{self.kind} closed before this request was "
                        f"served"))
                    if r.span is not None:
                        self.tracer.end_span(r.span, error="stranded")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- scheduler

    @abc.abstractmethod
    def _loop(self):
        """Worker thread body: drain `_pending` into batched engine
        calls until closed-and-drained."""

    def _n_matching_locked(self, group: tuple) -> int:
        return sum(r.group == group for r in self._pending)

    def _take_group_locked(self, group: tuple,
                           limit: int | None = None) -> list[_Request]:
        limit = self.max_batch if limit is None else limit
        took, rest = [], collections.deque()
        for r in self._pending:
            if r.group == group and len(took) < limit:
                took.append(r)
            else:
                rest.append(r)
        self._pending = rest
        return took

    @staticmethod
    def _resolve(future: Future, result=None, exc=None):
        """Deliver a result/exception, tolerating a client cancel() that
        lands between our check and the set_* call — an InvalidStateError
        here must never escape into (and kill) the scheduler thread."""
        try:
            if future.cancelled():
                return
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(result)
        except InvalidStateError:
            pass

    # ----------------------------------------------- retry / quarantine

    def _backoff(self, seconds: float):
        """Sleep `seconds` of scheduler-clock time (DESIGN.md §12: no
        raw time.sleep) — a timed condition wait re-checked against the
        deadline, so VirtualClock tests drive retry backoff with
        `advance()` exactly like flush deadlines."""
        if seconds <= 0:
            return
        cv = threading.Condition()
        deadline = self.clock.now() + float(seconds)
        with cv:
            while True:
                remaining = deadline - self.clock.now()
                if remaining <= 0:
                    return
                self.clock.wait(cv, remaining)

    def _run_single(self, r: _Request, k, ratio_k, ef_search):
        """One individual engine call for a retried request, at a shape
        the scheduler has already compiled.  Returns (row, stats)."""
        ids, stats = self._run_batch(r.Q[None], r.T[None], k,
                                     ratio_k=ratio_k, ef_search=ef_search)
        return np.asarray(ids[0]), stats

    def _retry_failed_batch(self, batch: list[_Request], exc, group):
        """Per-request recovery after a failed batched engine call
        (DESIGN.md §16): every rider re-runs individually under the
        retry policy, so a poison query fails alone — its batchmates'
        retries succeed — and is quarantined (rejected with the last
        exception, never retried again) once its attempts are spent.
        AssertionError (parity verification) is deterministic and fails
        the whole batch immediately, pre-resilience style."""
        k, ratio_k, ef_search = group
        tracer = self.tracer
        policy = self.retry_policy
        retryable = not isinstance(exc, AssertionError)
        for r in batch:
            r.n_attempts += 1              # the failed batched call
            last_exc = exc
            row = stats = None
            while retryable and r.n_attempts < policy.max_attempts:
                self._backoff(policy.backoff_s)
                r.n_attempts += 1
                self.n_retries += 1
                if self.telemetry is not None:
                    self.telemetry.record_retry()
                try:
                    row, stats = self._run_single(r, k, ratio_k, ef_search)
                    last_exc = None
                    break
                except Exception as e:     # noqa: BLE001 — to the policy
                    last_exc = e
            if last_exc is not None:
                self.n_quarantined += 1
                if self.telemetry is not None:
                    self.telemetry.record_quarantine()
                self._resolve(r.future, exc=last_exc)
                if r.span is not None:
                    tracer.end_span(r.span, error=repr(last_exc),
                                    attempts=r.n_attempts,
                                    quarantined=True)
            else:
                self._resolve(r.future,
                              result=(row, stats) if r.want_stats else row)
                if r.span is not None:
                    tracer.end_span(r.span, attempts=r.n_attempts,
                                    retried=True)


class MicroBatcher(Scheduler):
    """Flush-based dynamic micro-batcher (DESIGN.md §8).

    Concurrently submitted single-query requests land in the bounded
    queue; the worker drains them into one `search_batch` call per
    flush.  A flush fires when `max_batch` compatible requests are
    waiting or when the oldest request has waited `max_wait_ms` — the
    classic throughput/latency dial.

    Shape bucketing: the real batch is padded (by replicating the first
    request's query) up to the next power of two, capped at `max_batch`,
    so every arrival pattern maps onto a handful of compiled executables
    — zero recompiles after `warmup()` has touched each bucket.
    Padded-row results are discarded; real results scatter back to
    per-request futures.
    """

    kind = "microbatcher"

    def __init__(self, run_batch, *, max_batch: int = 32,
                 max_wait_ms: float = 2.0, max_queue: int = 256,
                 telemetry=None, verify_parity: bool = False,
                 verify_lock=None, clock: Clock | None = None,
                 name: str = "collection", tracer=None,
                 pad_policy: str = "replicate",
                 retry_policy: EngineRetryPolicy | None = None):
        # batch-padding policy (repro.sec, DESIGN.md §14):
        #   "replicate"  pad rows replicate a real query (perf)
        #   "dummy"      pad rows are zero dummy queries, counted in
        #                SearchStats.n_dummy_queries and telemetry
        #   "full"       dummy-pad every flush to max_batch, so batch
        #                size never leaks — still one warmup-compiled
        #                bucket per group, zero recompiles
        # Padded rows never reach a future under any policy, so results
        # are identical across policies.
        if pad_policy not in ("replicate", "dummy", "full"):
            raise ValueError(f"unknown pad_policy {pad_policy!r}")
        self.pad_policy = pad_policy
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.verify_parity = verify_parity
        # held across the batched call AND the parity re-runs, so a
        # concurrent mutation cannot change the database between the two
        # and fail the assert spuriously (pass the collection's RLock)
        self.verify_lock = verify_lock
        super().__init__(run_batch, max_batch=max_batch,
                         max_queue=max_queue, telemetry=telemetry,
                         clock=clock, name=name, tracer=tracer,
                         retry_policy=retry_policy)

    def warmup(self, example_q: np.ndarray, example_t: np.ndarray,
               k: int = 10, *, ratio_k: float = 8.0, ef_search: int = 96):
        """Compile every bucketed batch shape once, bypassing the queue."""
        for b in batch_buckets(self.max_batch):
            Q = np.broadcast_to(np.asarray(example_q), (b,) +
                                np.asarray(example_q).shape).copy()
            T = np.broadcast_to(np.asarray(example_t), (b,) +
                                np.asarray(example_t).shape).copy()
            self._run_batch(Q, T, k, ratio_k=ratio_k, ef_search=ef_search)

    # ---------------------------------------------------------- scheduler

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self.clock.wait(self._cv, None)
                if not self._pending:
                    return                       # closed and drained
                head = self._pending[0]
                deadline = head.t_enq + self.max_wait_s
                while (not self._closed
                       and self._n_matching_locked(head.group)
                       < self.max_batch):
                    remaining = deadline - self.clock.now()
                    if remaining <= 0:
                        break
                    self.clock.wait(self._cv, remaining)
                batch = self._take_group_locked(head.group)
                depth = len(self._pending)
            if batch:                            # all discarded mid-wait?
                self._flush(batch, depth)

    def _flush(self, batch: list[_Request], queue_depth: int):
        """Any failure lands on the batch's futures, never on the
        scheduler thread — one bad request must not wedge the queue."""
        k, ratio_k, ef_search = batch[0].group
        B = len(batch)
        tracer = self.tracer
        t_take = self.clock.now()      # queue wait ends, assembly begins
        batch_tid = ""
        try:
            bucket = (self.max_batch if self.pad_policy == "full"
                      else next_bucket(B, minimum=1,
                                       maximum=self.max_batch))
            if self.pad_policy == "replicate":
                pad_q, pad_t = batch[0].Q, batch[0].T
                n_dummies = 0
            else:           # dummy rows: zero-content queries that ride
                pad_q = np.zeros_like(batch[0].Q)     # the batched call
                pad_t = np.zeros_like(batch[0].T)     # but no future
                n_dummies = bucket - B
            Q = np.stack([r.Q for r in batch] + [pad_q] * (bucket - B))
            T = np.stack([r.T for r in batch] + [pad_t] * (bucket - B))
            lock = (self.verify_lock if self.verify_parity
                    and self.verify_lock is not None
                    else contextlib.nullcontext())
            with lock:
                if tracer is not None:
                    # the batch trace: one "flush" root over the engine
                    # call; the engine's filter/refine child spans attach
                    # under it through the ambient context
                    batch_tid = f"{self.name}:b{self._batch_seq}"
                    self._batch_seq += 1
                    bspan = tracer.span(
                        "flush", batch_tid, collection=self.name,
                        n_real=B, bucket=int(bucket), k=k)
                else:
                    bspan = contextlib.nullcontext()
                with bspan:
                    ids, stats = self._run_batch(Q, T, k, ratio_k=ratio_k,
                                                 ef_search=ef_search)
                    stats.n_dummy_queries = n_dummies
                    # sojourn latency ends when results are computed —
                    # before the (debug-only) parity sweep below, which
                    # would inflate p99
                    now = self.clock.now()
                    if tracer is not None:
                        bspan.set(**_stats_attrs(stats))
                if self.verify_parity:           # engine parity, per request
                    for i, r in enumerate(batch):
                        single, _ = self._run_batch(
                            r.Q[None], r.T[None], k, ratio_k=ratio_k,
                            ef_search=ef_search)
                        np.testing.assert_array_equal(ids[i], single[0])
        except Exception as exc:                 # noqa: BLE001 — to policy
            # never onto the scheduler thread: each rider retries
            # individually (at the warmup-compiled bucket-1 shape) and
            # is quarantined when its attempts run out (DESIGN.md §16)
            self._retry_failed_batch(batch, exc, batch[0].group)
            return
        for i, r in enumerate(batch):
            row = np.asarray(ids[i])
            self._resolve(r.future,
                          result=(row, stats) if r.want_stats else row)
        if tracer is not None:
            t_emit = self.clock.now()
            stats_attrs = _stats_attrs(stats)
            for r in batch:
                if r.span is None:
                    continue
                tracer.add_span("queue", r.trace_id, r.t_enq, t_take,
                                parent=r.span)
                tracer.add_span("flush", r.trace_id, t_take, now,
                                parent=r.span, batch=batch_tid,
                                n_real=B, backend=stats.backend)
                tracer.add_span("emit", r.trace_id, now, t_emit,
                                parent=r.span)
                tracer.end_span(r.span, **stats_attrs)
        if self.telemetry is not None:
            self.telemetry.record_flush(
                B, [now - r.t_enq for r in batch], stats,
                queue_depth, shape=Q.shape, n_dummies=n_dummies)
