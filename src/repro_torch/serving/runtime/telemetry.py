"""Per-collection serving telemetry (DESIGN.md §8, §13).

Every number the runtime reports is derived from the engine's uniform
`SearchStats` plus batcher-side timestamps — there is no second
accounting path to drift from the engine's.

Counters and gauges per collection:
  * request / reject / batch counts, insert / delete / compaction counts;
  * the accumulated `SearchStats` cost counters (paper §V-C: ciphertext
    distance evaluations, DCE comparisons, filter bytes scanned, bytes
    up/down) — the engine's communication/work model, operator-visible;
  * QPS over a sliding window;
  * batch occupancy (real requests per flushed batch — the coalescing
    win; > 1 means the micro-batcher is actually batching);
  * slot occupancy (continuous scheduler, DESIGN.md §12: active slots /
    table capacity per step, rolling mean — ≈ 1 at high arrival rate
    means the slot table refills as fast as it emits) and step counts;
  * p50 / p99 request sojourn latency (enqueue -> result) from a bounded
    reservoir of recent requests, plus insert -> emit sojourn for the
    slot loop (time a request actually occupied a slot row);
  * queue depth gauge (set by the scheduler on every transition);
  * recompile tracking: `jit_cache_size()` counts the kernel-library
    builds and loads of this process (the JAX package sums its jitted
    entry points' executable caches), so a bench or test can assert
    "zero recompiles after warmup" for both schedulers.

Time comes from the injected `Clock` (DESIGN.md §12) — telemetry never
reads wall time directly, so QPS windows, pruning, and sojourn math are
assertable on `VirtualClock` like everything else in the runtime.

When a `repro_torch.obs.MetricsRegistry` is attached (DESIGN.md §13), every
record_* call additionally feeds the cross-collection Prometheus
instruments (fixed-bucket latency histograms, labelled counters/gauges,
first-class recompile events with the triggering batch shape).  With no
registry attached — the default — none of that code runs.
"""

from __future__ import annotations

import collections
import threading
import time

__all__ = ["CollectionTelemetry", "jit_cache_size"]


def jit_cache_size() -> int:
    """Kernel-library builds and loads in this process
    (`kernels/_build.py`): the port's counterpart of the JAX package's
    executable-cache count.  The CUDA kernels are built once per source
    tree at their first launch and take any shape, so a steady value
    across a traffic phase == no rebuild after warmup.  A CUDA graph
    captured by a later change would count here too."""
    from ...kernels import _build
    return sum(_build.events.values())


class _ClockShim:
    """Wrap a bare clock-less default so the class body reads uniformly."""
    now = staticmethod(time.monotonic)


class CollectionTelemetry:
    """Thread-safe rolling metrics for one collection.

    clock: the runtime `Clock` the collection's scheduler runs on;
    None = wall time.  metrics/labels: an optional
    `repro_torch.obs.MetricsRegistry` plus the label values ({"tenant": ...,
    "collection": ...}) this collection exports under.
    """

    def __init__(self, window_s: float = 60.0, reservoir: int = 1024,
                 clock=None, metrics=None, labels=None):
        self.window_s = float(window_s)
        self.clock = clock if clock is not None else _ClockShim()
        self._t0 = self.clock.now()
        self._lock = threading.Lock()
        self._latencies = collections.deque(maxlen=reservoir)
        self._flushes = collections.deque()        # (t, n_real_requests)
        self._insert_to_emit = collections.deque(maxlen=reservoir)
        self._slot_occ = collections.deque(maxlen=reservoir)
        self.n_requests = 0
        self.n_rejected = 0
        self.n_batches = 0
        self.n_steps = 0
        self.n_batched_requests = 0
        self.n_inserts = 0
        self.n_deletes = 0
        self.n_compactions = 0
        self.queue_depth = 0
        self.last_backend = ""
        # accumulated SearchStats counters (paper §V-C): summed over
        # every batched engine call this collection served
        self.filter_dist_evals = 0
        self.refine_comparisons = 0
        self.filter_bytes_scanned = 0
        self.bytes_up = 0
        self.bytes_down = 0
        # security-profile overhead accounting (repro.sec, DESIGN.md
        # §14): dummy padding rows the schedulers injected, and result
        # bytes added by fixed-shape id padding.  Dummies never count
        # toward QPS/occupancy — those track n_real/n_active only.
        self.n_dummy_queries = 0
        self.padded_result_bytes = 0
        # graph-backend traversal accounting (repro.graph, DESIGN.md
        # §15): beam/greedy hops and edges scored, summed from the
        # engine's SearchStats — 0 for scan backends
        self.n_hops = 0
        self.n_edges_scanned = 0
        # resilience accounting (repro.resilience, DESIGN.md §16):
        # durability (WAL records logged / replayed, checkpoints
        # written), per-request retry/quarantine at the schedulers, and
        # degraded answers served while shard groups were down
        self.n_wal_records = 0
        self.n_wal_replayed = 0
        self.n_checkpoints = 0
        self.n_retries = 0
        self.n_quarantined = 0
        self.n_degraded_answers = 0
        self._wire_metrics(metrics, labels or {})

    # ------------------------------------------------- metrics exposition

    def _wire_metrics(self, metrics, labels: dict):
        """Register this collection's label-set on the shared registry.
        All _m_* handles stay None when no registry is attached, and the
        record_* paths skip exposition entirely."""
        self._labels = dict(labels)
        if metrics is None:
            self._m_requests = None
            return
        names = tuple(self._labels)
        c = lambda n, h: metrics.counter(n, h, names)        # noqa: E731
        self._m_requests = c("ann_requests_total",
                             "Requests admitted to the queue")
        self._m_rejected = c("ann_rejected_total",
                             "Requests shed by admission control")
        self._m_batches = c("ann_batches_total", "Flushed micro-batches")
        self._m_steps = c("ann_steps_total", "Slot-table steps")
        self._m_batched = c("ann_batched_requests_total",
                            "Requests served through batched engine calls")
        self._m_inserts = c("ann_inserts_total", "Rows inserted")
        self._m_deletes = c("ann_deletes_total", "Rows tombstoned")
        self._m_compactions = c("ann_compactions_total",
                                "Store compactions")
        self._m_dist = c("ann_filter_dist_evals_total",
                         "Ciphertext distance evaluations (filter stage)")
        self._m_cmp = c("ann_refine_comparisons_total",
                        "DCE comparison sign evaluations (refine stage)")
        self._m_scanned = c("ann_filter_bytes_scanned_total",
                            "Bytes the filter stage touched")
        self._m_up = c("ann_bytes_up_total",
                       "Serialized request bytes, client to server")
        self._m_down = c("ann_bytes_down_total",
                         "Serialized result bytes, server to client")
        self._m_hops = c("ann_graph_hops_total",
                         "Graph-backend traversal hops (filter stage)")
        self._m_edges = c("ann_graph_edges_scanned_total",
                          "Graph-backend edges scored (filter stage)")
        self._m_dummies = c("ann_dummy_queries_total",
                            "Dummy padding rows injected by the "
                            "scheduler (security profiles)")
        self._m_padded = c("ann_padded_bytes_total",
                           "Result bytes added by fixed-shape id "
                           "padding (security profiles)")
        self._m_wal = c("ann_wal_records_total",
                        "Acknowledged mutations appended to the WAL")
        self._m_wal_replayed = c("ann_wal_replayed_total",
                                 "WAL records replayed during recovery")
        self._m_checkpoints = c("ann_checkpoints_total",
                                "Background collection checkpoints "
                                "written")
        self._m_retries = c("ann_request_retries_total",
                            "Per-request engine-call retries after a "
                            "failed batch")
        self._m_quarantined = c("ann_quarantined_total",
                                "Requests quarantined after exhausting "
                                "retries (poison queries)")
        self._m_degraded = c("ann_degraded_answers_total",
                             "Engine calls answered with >= 1 shard "
                             "group down")
        self._m_queue = metrics.gauge(
            "ann_queue_depth", "Requests waiting in the scheduler queue",
            names)
        self._m_slot_occ = metrics.gauge(
            "ann_slot_occupancy",
            "Active slots / table capacity, last step", names)
        self._m_latency = metrics.histogram(
            "ann_request_latency_seconds",
            "Request sojourn latency, enqueue to result", names)
        self._m_sojourn = metrics.histogram(
            "ann_insert_to_emit_seconds",
            "Slot occupancy time, insert to emit", names)
        # recompiles as first-class events with the triggering shape:
        # the kernel library is process-wide, so deltas are attributed to
        # the collection (and batch shape) whose engine call grew them
        self._m_recompiles = metrics.counter(
            "ann_recompiles_total",
            "Kernel-library build and load events", names + ("shape",))
        self._cache_size_seen = jit_cache_size()

    def _record_compiles(self, shape):
        """Counter increment per newly compiled executable, labelled with
        the batch shape of the engine call that triggered it."""
        size = jit_cache_size()
        grew = size - self._cache_size_seen
        self._cache_size_seen = size
        if grew > 0:
            self._m_recompiles.inc(
                grew, shape=str(tuple(shape or ())), **self._labels)

    # ------------------------------------------------------------ recording

    def record_submit(self, queue_depth: int):
        with self._lock:
            self.n_requests += 1
            self.queue_depth = queue_depth
        if self._m_requests is not None:
            self._m_requests.inc(**self._labels)
            self._m_queue.set(queue_depth, **self._labels)

    def record_reject(self):
        with self._lock:
            self.n_rejected += 1
        if self._m_requests is not None:
            self._m_rejected.inc(**self._labels)

    def _accumulate_stats_locked(self, stats):
        self.last_backend = stats.backend
        self.filter_dist_evals += stats.filter_dist_evals
        self.refine_comparisons += stats.refine_comparisons
        self.filter_bytes_scanned += stats.filter_bytes_scanned
        self.bytes_up += stats.bytes_up
        self.bytes_down += stats.bytes_down
        self.n_dummy_queries += stats.n_dummy_queries
        self.n_hops += stats.n_hops
        self.n_edges_scanned += stats.n_edges_scanned
        self.n_degraded_answers += int(stats.degraded)

    def _export_stats(self, stats, latencies_s):
        self._m_dist.inc(stats.filter_dist_evals, **self._labels)
        self._m_cmp.inc(stats.refine_comparisons, **self._labels)
        self._m_scanned.inc(stats.filter_bytes_scanned, **self._labels)
        self._m_up.inc(stats.bytes_up, **self._labels)
        self._m_down.inc(stats.bytes_down, **self._labels)
        if stats.n_hops:
            self._m_hops.inc(stats.n_hops, **self._labels)
        if stats.n_edges_scanned:
            self._m_edges.inc(stats.n_edges_scanned, **self._labels)
        if stats.degraded:
            self._m_degraded.inc(**self._labels)
        for x in latencies_s:
            self._m_latency.observe(float(x), **self._labels)

    def record_flush(self, n_real: int, latencies_s, stats,
                     queue_depth: int, shape=None, n_dummies: int = 0):
        """One micro-batch flush: n_real real requests rode one engine
        call whose uniform accounting is `stats` (a SearchStats).
        `n_dummies` padding rows (security profiles) rode alongside —
        they feed `ann_dummy_queries_total` but never the QPS window,
        which counts n_real only."""
        now = self.clock.now()
        with self._lock:
            self.n_batches += 1
            self.n_batched_requests += n_real
            self.queue_depth = queue_depth
            self._accumulate_stats_locked(stats)
            self._flushes.append((now, n_real))
            self._latencies.extend(float(x) for x in latencies_s)
            horizon = now - self.window_s
            while self._flushes and self._flushes[0][0] < horizon:
                self._flushes.popleft()
        if self._m_requests is not None:
            self._m_batches.inc(**self._labels)
            self._m_batched.inc(n_real, **self._labels)
            self._m_queue.set(queue_depth, **self._labels)
            if n_dummies:
                self._m_dummies.inc(n_dummies, **self._labels)
            self._export_stats(stats, latencies_s)
            self._record_compiles(shape)

    def record_step(self, n_active: int, capacity: int, sojourn_s,
                    insert_to_emit_s, stats, queue_depth: int,
                    shape=None, n_dummies: int = 0):
        """One slot-table step (DESIGN.md §12): n_active of capacity
        slots held requests; both sojourn streams feed the reservoirs."""
        now = self.clock.now()
        occ = n_active / capacity if capacity else 0.0
        with self._lock:
            self.n_steps += 1
            self.n_batched_requests += n_active
            self.queue_depth = queue_depth
            self._accumulate_stats_locked(stats)
            self._slot_occ.append(occ)
            self._flushes.append((now, n_active))
            self._latencies.extend(float(x) for x in sojourn_s)
            self._insert_to_emit.extend(float(x) for x in insert_to_emit_s)
            horizon = now - self.window_s
            while self._flushes and self._flushes[0][0] < horizon:
                self._flushes.popleft()
        if self._m_requests is not None:
            self._m_steps.inc(**self._labels)
            self._m_batched.inc(n_active, **self._labels)
            self._m_queue.set(queue_depth, **self._labels)
            if n_dummies:
                self._m_dummies.inc(n_dummies, **self._labels)
            self._m_slot_occ.set(occ, **self._labels)
            self._export_stats(stats, sojourn_s)
            for x in insert_to_emit_s:
                self._m_sojourn.observe(float(x), **self._labels)
            self._record_compiles(shape)

    def record_padded_bytes(self, n_bytes: int):
        """Result bytes added by fixed-shape id padding (security
        profiles) — fed by the API layer at result-padding time, since
        the engine's `bytes_down` counts the unpadded payload."""
        if n_bytes <= 0:
            return
        with self._lock:
            self.padded_result_bytes += n_bytes
        if self._m_requests is not None:
            self._m_padded.inc(n_bytes, **self._labels)

    # resilience events (repro.resilience, DESIGN.md §16) --------------

    def record_wal(self, n: int = 1):
        """n acknowledged mutations appended (and fsync'd) to the WAL."""
        with self._lock:
            self.n_wal_records += n
        if self._m_requests is not None:
            self._m_wal.inc(n, **self._labels)

    def record_wal_replay(self, n: int):
        """n WAL records replayed into this collection at recovery."""
        with self._lock:
            self.n_wal_replayed += n
        if self._m_requests is not None and n:
            self._m_wal_replayed.inc(n, **self._labels)

    def record_checkpoint(self):
        """One background `.ppcol` checkpoint durably replaced."""
        with self._lock:
            self.n_checkpoints += 1
        if self._m_requests is not None:
            self._m_checkpoints.inc(**self._labels)

    def record_retry(self):
        """One per-request retry of a request whose batch call failed."""
        with self._lock:
            self.n_retries += 1
        if self._m_requests is not None:
            self._m_retries.inc(**self._labels)

    def record_quarantine(self):
        """One request quarantined after exhausting its retry budget."""
        with self._lock:
            self.n_quarantined += 1
        if self._m_requests is not None:
            self._m_quarantined.inc(**self._labels)

    def record_ingest(self, n_inserted: int = 0, n_deleted: int = 0,
                      compacted: bool = False):
        with self._lock:
            self.n_inserts += n_inserted
            self.n_deletes += n_deleted
            self.n_compactions += int(compacted)
        if self._m_requests is not None:
            if n_inserted:
                self._m_inserts.inc(n_inserted, **self._labels)
            if n_deleted:
                self._m_deletes.inc(n_deleted, **self._labels)
            if compacted:
                self._m_compactions.inc(**self._labels)

    # ------------------------------------------------------------- reading

    @staticmethod
    def _percentile(sorted_xs: list[float], p: float) -> float:
        if not sorted_xs:
            return 0.0
        i = min(len(sorted_xs) - 1, int(round(p * (len(sorted_xs) - 1))))
        return sorted_xs[i]

    def snapshot(self) -> dict:
        now = self.clock.now()
        with self._lock:
            horizon = now - self.window_s
            # prune here too: record_flush-only pruning would leave span
            # stretching past the window after a quiet gap, deflating qps
            while self._flushes and self._flushes[0][0] < horizon:
                self._flushes.popleft()
            served = sum(n for _, n in self._flushes)
            # rate over the observed lifetime, capped at the window — a
            # single fresh flush must not read as thousands of QPS
            span = min(self.window_s, now - self._t0)
            lat = sorted(self._latencies)
            ins = sorted(self._insert_to_emit)
            occupancy = (self.n_batched_requests / self.n_batches
                         if self.n_batches else 0.0)
            slot_occ = (sum(self._slot_occ) / len(self._slot_occ)
                        if self._slot_occ else 0.0)
            return {
                "backend": self.last_backend,
                "n_requests": self.n_requests,
                "n_rejected": self.n_rejected,
                "n_batches": self.n_batches,
                "n_steps": self.n_steps,
                "n_inserts": self.n_inserts,
                "n_deletes": self.n_deletes,
                "n_compactions": self.n_compactions,
                "queue_depth": self.queue_depth,
                "filter_dist_evals": self.filter_dist_evals,
                "refine_comparisons": self.refine_comparisons,
                "filter_bytes_scanned": self.filter_bytes_scanned,
                "bytes_up": self.bytes_up,
                "bytes_down": self.bytes_down,
                "n_dummy_queries": self.n_dummy_queries,
                "padded_result_bytes": self.padded_result_bytes,
                "n_hops": self.n_hops,
                "n_edges_scanned": self.n_edges_scanned,
                "n_wal_records": self.n_wal_records,
                "n_wal_replayed": self.n_wal_replayed,
                "n_checkpoints": self.n_checkpoints,
                "n_retries": self.n_retries,
                "n_quarantined": self.n_quarantined,
                "n_degraded_answers": self.n_degraded_answers,
                "qps": served / span if span > 0 else 0.0,
                "batch_occupancy": occupancy,
                "slot_occupancy": slot_occ,
                "p50_latency_s": self._percentile(lat, 0.50),
                "p99_latency_s": self._percentile(lat, 0.99),
                "p50_insert_to_emit_s": self._percentile(ins, 0.50),
                "p99_insert_to_emit_s": self._percentile(ins, 0.99),
            }
