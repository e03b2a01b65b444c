"""Continuous-batching slot-table serving loop (DESIGN.md §12).

The flush batcher's deadline is the p99 floor under open-loop traffic:
a lone request waits `max_wait_ms` hoping for company, and mixed
parameter groups head-of-line block behind the head group's deadline.
`SlotLoop` removes the flush entirely, the way an LLM decode engine
treats prefill/insert/generate: one persistent step over a fixed
`(max_batch,)` **slot table** whose rows hold query/trapdoor data plus
an active-slot validity mask.

  insert   new requests are written into free slot rows the moment the
           loop observes them — no deadline, no waiting for company;
  step     one batched engine call over the WHOLE table, every step,
           at the one compiled `(max_batch, d)` shape (inactive rows
           carry stale/zero queries whose results are simply never
           read — validity is data, not shape, exactly the `ok`
           row-validity convention of the adc_topk kernels);
  emit     completed rows scatter to their futures and the slots free.

Because an ANN search completes in a single engine call (unlike
iterative LLM decode), every active slot completes every step; the
continuous structure still pays off exactly where the flush batcher
hurts: a lone arrival is served immediately at the already-compiled
full-table shape, and under load the table refills to occupancy ≈ 1
with **zero** steady-state recompiles after a single `warmup()` — one
executable per parameter group, not one per bucket.

Requests sharing a step must agree on `(k, ratio_k, ef_search)` (the
executables specialize on them); the loop admits the head group each
step, FIFO, same as the flush batcher — so both schedulers serve any
request stream with bit-identical per-request ids (engine parity:
batched ids == per-query ids, independent of batch composition).
"""

from __future__ import annotations

import contextlib

import numpy as np

from .batcher import EngineRetryPolicy, Scheduler, _stats_attrs
from .clock import Clock

__all__ = ["SlotLoop"]


class SlotLoop(Scheduler):
    """Continuous-batching scheduler over one fixed slot table.

    Same client contract as `MicroBatcher` (submit/search/warmup/close,
    bounded-queue admission, futures, injected clock); the scheduling
    policy is the difference: no deadline, no buckets, one shape.

    `d`/`cdim` pre-allocate the table at construction (the runtime
    knows its collection's dims); left None, the table is allocated
    lazily from the first request's shapes — convenient for benches and
    tests driving the loop standalone.
    """

    kind = "slotloop"

    def __init__(self, run_batch, *, max_batch: int = 32,
                 max_queue: int = 256, d: int | None = None,
                 cdim: int | None = None, telemetry=None,
                 verify_parity: bool = False, verify_lock=None,
                 clock: Clock | None = None, name: str = "collection",
                 tracer=None, pad_policy: str = "replicate",
                 retry_policy: EngineRetryPolicy | None = None):
        # Padding policy (repro.sec, DESIGN.md §14).  The slot table is
        # always full-shape, so "full" adds nothing over "dummy" here;
        # under either, freed rows are scrubbed to zeros (a fixed dummy
        # query instead of a stale real one) and the inactive rows are
        # counted as dummies in SearchStats/telemetry.  "replicate"
        # (perf) keeps stale rows riding unscrubbed.
        if pad_policy not in ("replicate", "dummy", "full"):
            raise ValueError(f"unknown pad_policy {pad_policy!r}")
        self.pad_policy = pad_policy
        self._Q = self._T = None
        self._ok = np.zeros(int(max_batch), bool)
        self._slots = [None] * int(max_batch)        # _Request per row
        if d is not None and cdim is not None:
            self._alloc(int(d), int(cdim))
        self.verify_parity = verify_parity
        self.verify_lock = verify_lock
        super().__init__(run_batch, max_batch=max_batch,
                         max_queue=max_queue, telemetry=telemetry,
                         clock=clock, name=name, tracer=tracer,
                         retry_policy=retry_policy)

    # ---------------------------------------------------------- the table

    def _alloc(self, d: int, cdim: int):
        self._Q = np.zeros((self._ok.size, d), np.float32)
        self._T = np.zeros((self._ok.size, cdim), np.float32)

    @property
    def capacity(self) -> int:
        return self._ok.size

    @property
    def n_active(self) -> int:
        return int(self._ok.sum())

    def _insert(self, batch):
        """Write requests into free slot rows; validity flips to True.
        Rows of freed slots keep their stale queries — already-compiled
        data the step computes and the emit never reads."""
        if self._Q is None:
            self._alloc(np.asarray(batch[0].Q).shape[-1],
                        np.asarray(batch[0].T).shape[-1])
        free = np.flatnonzero(~self._ok)
        now = self.clock.now()
        for slot, req in zip(free, batch):
            self._Q[slot] = req.Q
            self._T[slot] = req.T
            self._ok[slot] = True
            self._slots[slot] = req
            req.t_insert = now
            if req.span is not None:
                # queue wait ends the moment the row enters a slot; the
                # "slot" occupancy span is stamped at emit (_step)
                self.tracer.add_span("queue", req.trace_id, req.t_enq,
                                     now, parent=req.span)

    # ---------------------------------------------------------- scheduler

    def warmup(self, example_q: np.ndarray, example_t: np.ndarray,
               k: int = 10, *, ratio_k: float = 8.0, ef_search: int = 96):
        """One full-table step per parameter group is the ENTIRE warmup:
        the slot loop only ever runs the `(max_batch, d)` shape."""
        eq = np.asarray(example_q)
        et = np.asarray(example_t)
        if self._Q is None:
            self._alloc(eq.shape[-1], et.shape[-1])
        Q = np.broadcast_to(eq, self._Q.shape).copy()
        T = np.broadcast_to(et, self._T.shape).copy()
        self._run_batch(Q, T, k, ratio_k=ratio_k, ef_search=ef_search)

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self.clock.wait(self._cv, None)
                if not self._pending:
                    return                       # closed and drained
                # no deadline: launch the step with whatever is waiting.
                # Head parameter group only — the executables specialize
                # on (k, ratio_k, ef_search); other groups keep their
                # queue position for the next step (steps are the unit
                # of progress, so head-of-line blocking is one step, not
                # one deadline).
                group = self._pending[0].group
                n_free = int((~self._ok).sum())
                batch = self._take_group_locked(group, limit=n_free)
                depth = len(self._pending)
            if batch:                            # all discarded mid-wait?
                self._insert(batch)
                self._step(group, depth)

    def _step(self, group: tuple, queue_depth: int):
        """One batched engine call over the whole table; emit every
        active row.  Any failure lands on the active slots' futures —
        never on the loop thread — and the slots free either way."""
        k, ratio_k, ef_search = group
        active = np.flatnonzero(self._ok)
        tracer = self.tracer
        step_tid = ""
        try:
            lock = (self.verify_lock if self.verify_parity
                    and self.verify_lock is not None
                    else contextlib.nullcontext())
            with lock:
                if tracer is not None:
                    # the step trace: one "step" root over the full-table
                    # engine call; filter/refine children attach under it
                    step_tid = f"{self.name}:s{self._batch_seq}"
                    self._batch_seq += 1
                    sspan = tracer.span(
                        "step", step_tid, collection=self.name,
                        n_active=int(active.size),
                        capacity=int(self.capacity), k=k)
                else:
                    sspan = contextlib.nullcontext()
                with sspan:
                    ids, stats = self._run_batch(self._Q, self._T, k,
                                                 ratio_k=ratio_k,
                                                 ef_search=ef_search)
                    n_dummies = (self.capacity - int(active.size)
                                 if self.pad_policy != "replicate" else 0)
                    stats.n_dummy_queries = n_dummies
                    now = self.clock.now()
                    if tracer is not None:
                        sspan.set(**_stats_attrs(stats))
                if self.verify_parity:           # engine parity, per slot
                    for slot in active:
                        r = self._slots[slot]
                        single, _ = self._run_batch(
                            r.Q[None], r.T[None], k, ratio_k=ratio_k,
                            ef_search=ef_search)
                        np.testing.assert_array_equal(ids[slot], single[0])
        except Exception as exc:                 # noqa: BLE001 — to policy
            # free the slots first (the table must keep serving), then
            # recover per request: each rider retries individually at
            # the one compiled full-table shape (DESIGN.md §16)
            riders = [self._slots[slot] for slot in active]
            for slot in active:
                self._free(slot)
            self._retry_failed_batch(riders, exc, group)
            return
        sojourn, insert_to_emit = [], []
        t_emit = self.clock.now() if tracer is not None else now
        stats_attrs = _stats_attrs(stats) if tracer is not None else None
        for slot in active:
            r = self._slots[slot]
            row = np.asarray(ids[slot])
            self._resolve(r.future,
                          result=(row, stats) if r.want_stats else row)
            sojourn.append(now - r.t_enq)
            insert_to_emit.append(now - r.t_insert)
            if r.span is not None:
                tracer.add_span("slot", r.trace_id, r.t_insert, now,
                                parent=r.span, slot=int(slot),
                                batch=step_tid, backend=stats.backend)
                tracer.add_span("emit", r.trace_id, now, t_emit,
                                parent=r.span)
                tracer.end_span(r.span, **stats_attrs)
            self._free(slot)
        if self.telemetry is not None:
            self.telemetry.record_step(
                len(active), self.capacity, sojourn, insert_to_emit,
                stats, queue_depth, shape=self._Q.shape,
                n_dummies=n_dummies)

    def _free(self, slot: int):
        self._ok[slot] = False
        self._slots[slot] = None
        if self.pad_policy != "replicate" and self._Q is not None:
            self._Q[slot] = 0.0          # scrub: freed row becomes the
            self._T[slot] = 0.0          # fixed zero dummy query

    def _run_single(self, r, k, ratio_k, ef_search):
        """Retry at the ONE compiled shape: the request's query
        broadcast across the full table (a (1, d) call would compile a
        second executable and break the zero-recompile contract)."""
        Q = np.broadcast_to(np.asarray(r.Q), self._Q.shape).copy()
        T = np.broadcast_to(np.asarray(r.T), self._T.shape).copy()
        ids, stats = self._run_batch(Q, T, k, ratio_k=ratio_k,
                                     ef_search=ef_search)
        return np.asarray(ids[0]), stats
