"""The port's online serving runtime (`repro_torch.serving.runtime`):
scheduler unit behaviour (flush micro-batcher + continuous slot loop) on
virtual time, bucketed shapes, multi-tenant routing, telemetry, and
admission control (DESIGN.md §8, §12) — the cases of
tests/test_runtime.py and tests/test_telemetry.py in port form, with
every collection on the CPU (`device="cpu"`, the plain versions).

Every scheduler test here drives time through the injected
`VirtualClock` — no wall-clock sleeps, no timing-dependent assertions:
a deadline fires exactly when the test `advance()`s past it, and
`wait_for_waiters()` is the deterministic "the scheduler is parked on
its deadline" sync point.
"""

import threading
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np
import pytest

from repro_torch.core import dcpe
from repro_torch.data import synth
from repro_torch.kernels import _build
from repro_torch.kernels.common import next_bucket
from repro_torch.obs import MetricsRegistry
from repro_torch.serving.runtime import (Collection, CollectionManager,
                                         CollectionTelemetry, MicroBatcher,
                                         QueueFullError, SlotLoop,
                                         TenantIsolationError, VirtualClock,
                                         batch_buckets, jit_cache_size)
from repro_torch.serving.search_engine import SearchStats

K = 10
D = 24


def _fake_stats(nq):
    return SearchStats(latency_s=0.0, filter_dist_evals=0,
                       refine_comparisons=0, bytes_up=0, bytes_down=0,
                       n_queries=nq, backend="fake")


class FakeEngine:
    """Deterministic run_batch: ids[i] = round(Q[i, 0]) .. +k, recorded.
    The gate is the only synchronization — no sleeps anywhere."""

    def __init__(self):
        self.calls = []            # (batch_shape, k)
        self.seen_bases = []       # every request value ever computed
        self.gate = threading.Event()
        self.gate.set()

    def __call__(self, Q, T, k, ratio_k=8.0, ef_search=96):
        self.gate.wait(timeout=10.0)
        Q = np.atleast_2d(Q)
        self.calls.append((Q.shape, k))
        base = np.round(Q[:, 0]).astype(np.int64)
        self.seen_bases.extend(int(b) for b in base)
        ids = base[:, None] + np.arange(k)[None, :]
        return ids, _fake_stats(Q.shape[0])


def _req(i):
    return np.full(D, float(i), np.float32), np.zeros(2 * D + 16, np.float32)


# ------------------------------------------------------------- batcher unit


def test_batch_buckets_shapes():
    assert batch_buckets(32) == [1, 2, 4, 8, 16, 32]
    assert batch_buckets(24) == [1, 2, 4, 8, 16, 24]
    assert batch_buckets(1) == [1]


def test_coalesces_concurrent_requests_and_pads_to_bucket():
    eng = FakeEngine()
    eng.gate.clear()                       # hold the worker at the gate
    vc = VirtualClock()
    with MicroBatcher(eng, max_batch=8, max_wait_ms=40.0, clock=vc) as mb:
        futs = [mb.submit(*_req(i), K) for i in range(5)]
        vc.advance(0.041)                  # virtual deadline passes
        eng.gate.set()
        res = [f.result(timeout=10) for f in futs]
    for i, ids in enumerate(res):          # results scatter to the right
        np.testing.assert_array_equal(ids, i + np.arange(K))
    # 5 real requests ride one flush, padded to the 8-bucket
    flush_shapes = [s for s, _ in eng.calls]
    assert (8, D) in flush_shapes and len(flush_shapes) == 1


def test_full_batch_flushes_without_waiting_deadline():
    """max_batch compatible requests flush by SIZE: virtual time never
    advances, so any result proves the deadline was not involved."""
    eng = FakeEngine()
    eng.gate.clear()
    vc = VirtualClock()
    with MicroBatcher(eng, max_batch=4, max_wait_ms=10_000.0,
                      clock=vc) as mb:
        futs = [mb.submit(*_req(i), K) for i in range(4)]
        eng.gate.set()
        for f in futs:
            f.result(timeout=10)           # resolves at t=0 virtual
    assert vc.now() == 0.0
    assert eng.calls[0][0] == (4, D)


def test_deadline_flush_for_lone_request():
    """A lone request waits exactly until the virtual deadline: not
    flushed before the advance, flushed right after."""
    eng = FakeEngine()
    vc = VirtualClock()
    with MicroBatcher(eng, max_batch=32, max_wait_ms=30.0, clock=vc) as mb:
        fut = mb.submit(*_req(3), K)
        vc.wait_for_waiters(1)             # parked on the deadline
        assert not fut.done()
        vc.advance(0.029)                  # 29 ms: not yet due
        vc.wait_for_waiters(1)
        assert not fut.done()
        vc.advance(0.002)                  # past 30 ms: flush
        np.testing.assert_array_equal(fut.result(timeout=10),
                                      3 + np.arange(K))
    assert eng.calls[0][0] == (1, D)       # bucket 1, no padding waste


def test_mixed_k_requests_flush_as_separate_groups():
    eng = FakeEngine()
    eng.gate.clear()
    vc = VirtualClock()
    with MicroBatcher(eng, max_batch=8, max_wait_ms=30.0, clock=vc) as mb:
        f1 = [mb.submit(*_req(i), 5) for i in range(3)]
        f2 = [mb.submit(*_req(10 + i), 7) for i in range(3)]
        vc.advance(1.0)
        eng.gate.set()
        r1 = [f.result(timeout=10) for f in f1]
        r2 = [f.result(timeout=10) for f in f2]
    assert all(r.shape == (5,) for r in r1)
    assert all(r.shape == (7,) for r in r2)
    assert sorted(k for _, k in eng.calls) == [5, 7]


def test_backpressure_rejects_when_queue_full():
    eng = FakeEngine()
    eng.gate.clear()                       # wedge the worker
    vc = VirtualClock()
    mb = MicroBatcher(eng, max_batch=2, max_wait_ms=5.0, max_queue=3,
                      clock=vc)
    try:
        accepted = []
        with pytest.raises(QueueFullError):
            for i in range(20):
                accepted.append(mb.submit(*_req(i), K))
        assert len(accepted) >= 3          # queue capacity was usable
        eng.gate.set()
        vc.advance(1.0)
        for f in accepted:
            f.result(timeout=10)           # backlog drains after release
    finally:
        mb.close()


def test_search_timeout_discards_queued_request():
    """Regression: `search()` timing out used to leave the request
    queued — a dead future the scheduler later computed into, holding an
    admission-control slot the whole time.  The timeout must cancel the
    future AND free the queue slot."""
    eng = FakeEngine()
    eng.gate.clear()                       # worker wedges on request A
    vc = VirtualClock()
    mb = MicroBatcher(eng, max_batch=1, max_wait_ms=0.0, max_queue=2,
                      clock=vc)
    try:
        fut_a = mb.submit(*_req(1), K)     # taken by the worker (size=1)
        with pytest.raises(FutureTimeoutError):  # B stays queued behind A
            mb.search(*_req(2), K, timeout=0.05)
        # the timed-out request left the queue: both slots are free again
        with mb._cv:
            assert len(mb._pending) == 0
        fut_c = mb.submit(*_req(3), K)
        fut_d = mb.submit(*_req(4), K)     # full max_queue=2 available
        eng.gate.set()
        np.testing.assert_array_equal(fut_a.result(timeout=10),
                                      1 + np.arange(K))
        np.testing.assert_array_equal(fut_c.result(timeout=10),
                                      3 + np.arange(K))
        np.testing.assert_array_equal(fut_d.result(timeout=10),
                                      4 + np.arange(K))
        # the discarded request was never computed: only A, C, D flushed
        assert len(eng.calls) == 3
        assert 2 not in eng.seen_bases
    finally:
        mb.close()


def test_discard_after_completion_keeps_result():
    eng = FakeEngine()
    with MicroBatcher(eng, max_batch=1, max_wait_ms=0.0) as mb:
        fut = mb.submit(*_req(5), K)
        np.testing.assert_array_equal(fut.result(timeout=10),
                                      5 + np.arange(K))
        assert mb.discard(fut) is False    # too late: result stands
        np.testing.assert_array_equal(fut.result(timeout=0),
                                      5 + np.arange(K))


def test_malformed_request_cannot_doom_its_flush_or_the_scheduler():
    """A ragged request breaks its flush's batch assembly (np.stack), but
    per-request retry (DESIGN.md §16) re-runs each rider alone: the
    batchmate still gets its answer, the ragged request is answered at
    its own shape, and the worker thread keeps serving later requests."""
    eng = FakeEngine()
    eng.gate.clear()
    vc = VirtualClock()
    with MicroBatcher(eng, max_batch=8, max_wait_ms=20.0, clock=vc) as mb:
        good1 = mb.submit(*_req(1), K)
        bad = mb.submit(np.zeros(D + 3, np.float32),
                        np.zeros(2 * D + 16, np.float32), K)  # ragged Q
        vc.advance(0.021)
        eng.gate.set()
        np.testing.assert_array_equal(good1.result(timeout=10),
                                      1 + np.arange(K))   # batchmate survives
        np.testing.assert_array_equal(bad.result(timeout=10),
                                      0 + np.arange(K))   # solo, own shape
        solo_shapes = [s for s, _ in eng.calls]
        assert (1, D) in solo_shapes and (1, D + 3) in solo_shapes
        good2 = mb.submit(*_req(2), K)           # scheduler still alive
        vc.advance(0.021)
        np.testing.assert_array_equal(good2.result(timeout=10),
                                      2 + np.arange(K))


def test_cancelled_future_does_not_kill_scheduler():
    """A client cancelling its pending future must not crash the flush
    or the scheduler thread (InvalidStateError race regression)."""
    eng = FakeEngine()
    eng.gate.clear()
    vc = VirtualClock()
    with MicroBatcher(eng, max_batch=4, max_wait_ms=10.0, clock=vc) as mb:
        f1 = mb.submit(*_req(1), K)
        f2 = mb.submit(*_req(2), K)
        assert f1.cancel()                     # still pending: cancellable
        vc.advance(0.011)
        eng.gate.set()
        np.testing.assert_array_equal(f2.result(timeout=10),
                                      2 + np.arange(K))
        f3 = mb.submit(*_req(3), K)            # scheduler still alive
        vc.advance(0.011)
        np.testing.assert_array_equal(f3.result(timeout=10),
                                      3 + np.arange(K))


def test_engine_exception_propagates_to_futures():
    def boom(Q, T, k, **kw):
        raise RuntimeError("engine down")

    with MicroBatcher(boom, max_batch=1, max_wait_ms=5.0) as mb:
        fut = mb.submit(*_req(0), K)           # size-1 flush: no deadline
        with pytest.raises(RuntimeError, match="engine down"):
            fut.result(timeout=10)


def test_close_drains_pending_then_rejects():
    eng = FakeEngine()
    eng.gate.clear()                           # hold the first flush
    vc = VirtualClock()
    mb = MicroBatcher(eng, max_batch=4, max_wait_ms=2.0, clock=vc)
    futs = [mb.submit(*_req(i), K) for i in range(6)]
    eng.gate.set()
    mb.close()                                 # close drains, no deadline
    for f in futs:
        assert f.result(timeout=10) is not None
    with pytest.raises(RuntimeError):
        mb.submit(*_req(0), K)


# --------------------------------------------------- slot loop (continuous)


def test_slot_loop_serves_lone_request_with_no_deadline():
    """The continuous scheduler's whole point: a lone arrival is served
    immediately — virtual time stays at 0, nothing waits on a clock."""
    eng = FakeEngine()
    vc = VirtualClock()
    with SlotLoop(eng, max_batch=8, clock=vc) as sl:
        fut = sl.submit(*_req(3), K)
        np.testing.assert_array_equal(fut.result(timeout=10),
                                      3 + np.arange(K))
    assert vc.now() == 0.0
    assert eng.calls[0][0] == (8, D)           # the one table shape


def test_slot_loop_runs_one_shape_only():
    """Every step — lone request or full table — runs the (max_batch, d)
    slot-table shape: one executable, zero recompiles by construction."""
    eng = FakeEngine()
    eng.gate.clear()
    with SlotLoop(eng, max_batch=4, clock=VirtualClock()) as sl:
        futs = [sl.submit(*_req(i), K) for i in range(7)]
        eng.gate.set()
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=10),
                                          i + np.arange(K))
    assert all(shape == (4, D) for shape, _ in eng.calls)
    assert len(eng.calls) >= 2                 # 7 requests > one table


def test_slot_loop_inserts_into_free_slots_and_emits():
    """Requests admitted while the table is partly full land in free
    rows; emitted rows free their slots for the next step."""
    eng = FakeEngine()
    eng.gate.clear()
    with SlotLoop(eng, max_batch=2, clock=VirtualClock()) as sl:
        futs = [sl.submit(*_req(i), K) for i in range(5)]
        eng.gate.set()
        res = [f.result(timeout=10) for f in futs]
        assert sl.n_active == 0                # all slots freed
    for i, ids in enumerate(res):
        np.testing.assert_array_equal(ids, i + np.arange(K))


def test_slot_loop_mixed_groups_step_separately():
    eng = FakeEngine()
    eng.gate.clear()
    with SlotLoop(eng, max_batch=8, clock=VirtualClock()) as sl:
        f1 = [sl.submit(*_req(i), 5) for i in range(3)]
        f2 = [sl.submit(*_req(10 + i), 7) for i in range(3)]
        eng.gate.set()
        r1 = [f.result(timeout=10) for f in f1]
        r2 = [f.result(timeout=10) for f in f2]
    assert all(r.shape == (5,) for r in r1)
    assert all(r.shape == (7,) for r in r2)
    assert sorted(set(k for _, k in eng.calls)) == [5, 7]


def test_slot_loop_backpressure_and_close():
    eng = FakeEngine()
    eng.gate.clear()
    sl = SlotLoop(eng, max_batch=2, max_queue=3, clock=VirtualClock())
    try:
        accepted = []
        with pytest.raises(QueueFullError):
            for i in range(20):
                accepted.append(sl.submit(*_req(i), K))
        assert len(accepted) >= 3
        eng.gate.set()
        for f in accepted:
            f.result(timeout=10)
    finally:
        sl.close()
    with pytest.raises(RuntimeError):
        sl.submit(*_req(0), K)


def test_slot_loop_telemetry_occupancy_and_sojourn():
    eng = FakeEngine()
    eng.gate.clear()
    tel = CollectionTelemetry()
    with SlotLoop(eng, max_batch=4, telemetry=tel,
                  clock=VirtualClock()) as sl:
        futs = [sl.submit(*_req(i), K) for i in range(4)]
        eng.gate.set()
        for f in futs:
            f.result(timeout=10)
    snap = tel.snapshot()
    assert snap["n_steps"] >= 1
    assert 0.0 < snap["slot_occupancy"] <= 1.0
    assert snap["n_requests"] == 4
    assert snap["p99_insert_to_emit_s"] >= 0.0


# --------------------------------------------------------- tenancy routing


@pytest.fixture(scope="module")
def ds():
    return synth.make_dataset("deep1m", n=400, n_queries=6, k_gt=20,
                              seed=7, d=D)


@pytest.fixture()
def mgr(ds):
    beta = dcpe.suggest_beta(ds.base, fraction=0.03)
    with CollectionManager(sap_beta=beta, max_wait_ms=3.0,
                           device="cpu") as m:
        yield m


def test_strict_tenant_routing(mgr, ds):
    mgr.create_collection("acme", "docs", D, seed=1)
    mgr.create_collection("globex", "docs", D, seed=2)
    mgr.insert("acme", "docs", ds.base[:100])
    mgr.insert("globex", "docs", ds.base[100:200])
    # wrong tenant for an existing collection name -> isolation error
    with pytest.raises(TenantIsolationError):
        mgr.collection("initech", "docs")
    # unknown name raises the *same* error: "owned by someone else" and
    # "nonexistent" must be indistinguishable (no enumeration oracle)
    with pytest.raises(TenantIsolationError) as e_other:
        mgr.collection("initech", "docs")
    with pytest.raises(TenantIsolationError) as e_none:
        mgr.collection("initech", "no-such-thing")
    assert type(e_other.value) is type(e_none.value)
    assert isinstance(e_none.value, KeyError)      # still a lookup error
    # per-tenant keys differ: same name, independent crypto
    ka = mgr.collection("acme", "docs").owner.keys.dce_key.M3
    kg = mgr.collection("globex", "docs").owner.keys.dce_key.M3
    assert not np.allclose(ka, kg)
    # duplicate create rejected
    with pytest.raises(ValueError):
        mgr.create_collection("acme", "docs", D)


def test_default_seeds_yield_distinct_tenant_keys(mgr):
    """Two tenants that never pass a seed must still get different key
    material (regression: a shared default seed made keys collide)."""
    a = mgr.create_collection("t-a", "c", D)
    b = mgr.create_collection("t-b", "c", D)
    assert not np.allclose(a.owner.keys.dce_key.M3, b.owner.keys.dce_key.M3)


def test_unknown_scheduler_rejected(mgr):
    with pytest.raises(ValueError, match="unknown scheduler"):
        mgr.create_collection("acme", "bad-sched", D, scheduler="nope")


def test_submit_rejects_wrong_dimension_query(mgr, ds):
    col = mgr.create_collection("acme", "dims", D)
    col.insert(ds.base[:50])
    with pytest.raises(ValueError, match="query shapes"):
        col.submit(np.zeros(D + 1, np.float32),
                   np.zeros(2 * D + 16, np.float32), K)
    with pytest.raises(ValueError, match="query shapes"):
        col.submit(np.zeros(D, np.float32), np.zeros(7, np.float32), K)


def test_store_append_rejects_row_count_mismatch(mgr, ds):
    col = mgr.create_collection("acme", "wire", D)
    C_sap, C_dce = col.owner.encrypt_vectors(ds.base[:3], device="cpu")
    with pytest.raises(ValueError, match="ciphertext shapes"):
        col.insert_encrypted(C_sap, C_dce[:1])   # truncated wire payload
    col.insert_encrypted(C_sap, C_dce)           # matched payload is fine
    assert col.store.n_total == 3


def test_cross_tenant_trapdoors_never_touch_other_store(mgr, ds):
    """Routing is by (tenant, collection): tenant B's search runs only on
    B's ciphertexts even when A's collection shares the name."""
    a = mgr.create_collection("acme", "docs", D, seed=1)
    b = mgr.create_collection("globex", "docs", D, seed=2)
    a.insert(ds.base[:200])
    b.insert(ds.base[200:250])
    qa = a.new_user().encrypt_query(ds.queries[0])
    ids = mgr.search("acme", "docs", *qa, K, ef_search=96)
    assert (ids[ids >= 0] < 200).all()          # rows of A's store only
    ids_b = mgr.search("globex", "docs", *qa, K)   # wrong keys: garbage,
    assert ids_b.shape == (K,)                     # but never A's data


def test_empty_collection_returns_sentinels(mgr):
    mgr.create_collection("acme", "fresh", D)
    q, t = _req(0)
    ids = mgr.search("acme", "fresh", q, t, K)
    assert (ids == -1).all()


def test_empty_collection_continuous_returns_sentinels(mgr):
    mgr.create_collection("acme", "fresh-slot", D, scheduler="continuous")
    q, t = _req(0)
    ids = mgr.search("acme", "fresh-slot", q, t, K)
    assert (ids == -1).all()


def test_drop_collection(mgr, ds):
    mgr.create_collection("acme", "tmp", D)
    mgr.drop_collection("acme", "tmp")
    with pytest.raises(KeyError):
        mgr.collection("acme", "tmp")


# ------------------------------------------------- end-to-end + telemetry


def test_concurrent_clients_results_match_direct_engine(mgr, ds):
    col = mgr.create_collection("acme", "main", D, seed=3,
                                max_wait_ms=20.0, verify_parity=True)
    col.insert(ds.base)
    user = col.new_user()
    enc = [user.encrypt_query(q) for q in ds.queries]
    futs = [col.submit(c, t, K, ef_search=96) for c, t in enc]
    via_batcher = np.stack([f.result(timeout=30) for f in futs])
    Q = np.stack([c for c, _ in enc])
    T = np.stack([t for _, t in enc])
    direct, _ = col.search_batch(Q, T, K, ef_search=96)
    np.testing.assert_array_equal(via_batcher, direct)
    snap = col.stats()
    assert snap["n_requests"] == len(enc)
    assert snap["batch_occupancy"] > 1.0        # coalescing happened
    assert snap["p99_latency_s"] >= snap["p50_latency_s"] > 0
    assert snap["n_alive"] == ds.n
    assert synth.recall_at_k(via_batcher, ds.gt, K) >= 0.8


def test_continuous_collection_matches_direct_engine(mgr, ds):
    """The slot loop through the full Collection path: parity-verified
    per slot against the engine, occupancy + sojourn telemetry."""
    col = mgr.create_collection("acme", "slot-main", D, seed=3,
                                scheduler="continuous", max_batch=8,
                                verify_parity=True)
    col.insert(ds.base)
    col.compact()
    user = col.new_user()
    enc = [user.encrypt_query(q) for q in ds.queries]
    futs = [col.submit(c, t, K, ef_search=96) for c, t in enc]
    via_slots = np.stack([f.result(timeout=30) for f in futs])
    Q = np.stack([c for c, _ in enc])
    T = np.stack([t for _, t in enc])
    direct, _ = col.search_batch(Q, T, K, ef_search=96)
    np.testing.assert_array_equal(via_slots, direct)
    snap = col.stats()
    assert snap["scheduler"] == "continuous"
    assert snap["n_steps"] >= 1
    assert snap["slot_occupancy"] > 0.0
    assert synth.recall_at_k(via_slots, ds.gt, K) >= 0.8


def test_zero_recompiles_across_bucketed_batch_sizes(mgr, ds):
    """After warmup over the bucketed shapes, traffic at every batch size
    and live ingestion inside a capacity bucket build and load no kernel
    library (`jit_cache_size`, the port's recompile audit; the CPU's
    plain versions never reach the build at all)."""
    col = mgr.create_collection("acme", "warm", D, seed=4, max_batch=8,
                                max_wait_ms=1.0)
    col.insert(ds.base)
    col.compact()
    col.warmup(K, ratio_k=8.0, ef_search=96)
    user = col.new_user()
    enc = [user.encrypt_query(q) for q in ds.queries]
    before = jit_cache_size()
    for B in (1, 2, 3, 5, 6, 4, 1):            # ragged arrival patterns
        Q = np.stack([enc[i % len(enc)][0] for i in range(B)])
        T = np.stack([enc[i % len(enc)][1] for i in range(B)])
        b = next_bucket(B, maximum=8)
        Qp = np.concatenate([Q, np.repeat(Q[:1], b - B, 0)])
        Tp = np.concatenate([T, np.repeat(T[:1], b - B, 0)])
        col.search_batch(Qp, Tp, K, ratio_k=8.0, ef_search=96)
    assert jit_cache_size() == before
    # live ingestion: further insert bursts inside the same capacity
    # bucket are written into the device tensors already held
    col.insert(ds.base[:4])
    q0, t0 = enc[0]
    col.search_batch(q0[None], t0[None], K, ratio_k=8.0, ef_search=96)
    settled = jit_cache_size()
    for _ in range(3):
        col.insert(ds.base[:4])
        col.search_batch(q0[None], t0[None], K, ratio_k=8.0, ef_search=96)
    assert jit_cache_size() == settled


def test_slot_loop_zero_recompiles_after_single_warmup(mgr, ds):
    """The continuous scheduler: ONE warmup step, then ragged arrival
    patterns all run the one (max_batch, d) shape, with no build."""
    col = mgr.create_collection("acme", "slot-warm", D, seed=4,
                                scheduler="continuous", max_batch=8)
    col.insert(ds.base)
    col.compact()
    col.warmup(K, ratio_k=8.0, ef_search=96)   # one full-table step
    user = col.new_user()
    enc = [user.encrypt_query(q) for q in ds.queries]
    before = jit_cache_size()
    for burst in (1, 5, 2, 6, 1, 3):           # ragged arrival patterns
        futs = [col.submit(*enc[i % len(enc)], K, ef_search=96)
                for i in range(burst)]
        for f in futs:
            f.result(timeout=30)
    assert jit_cache_size() == before          # zero steady-state compiles


def test_jit_cache_size_counts_kernel_builds_and_loads(monkeypatch):
    """The port's recompile audit is the kernel library's build and load
    events; telemetry turns growth into `ann_recompiles_total` samples
    labelled with the triggering batch shape."""
    monkeypatch.setattr(_build, "events", {"builds": 0, "loads": 0})
    assert jit_cache_size() == 0
    reg = MetricsRegistry()
    tel = CollectionTelemetry(clock=VirtualClock(), metrics=reg,
                              labels={"tenant": "t", "collection": "c"})
    _build.events["builds"] += 1               # a first launch: nvcc ...
    _build.events["loads"] += 1                # ... then the ctypes load
    assert jit_cache_size() == 2
    tel.record_flush(1, [0.01], _fake_stats(1), queue_depth=0,
                     shape=(1, D))
    tel.record_flush(1, [0.01], _fake_stats(1), queue_depth=0,
                     shape=(1, D))             # no growth: no sample
    assert reg.get("ann_recompiles_total").value(
        tenant="t", collection="c", shape=str((1, D))) == 2


def test_telemetry_counts_rejects(ds):
    beta = dcpe.suggest_beta(ds.base, fraction=0.03)
    col = None
    try:
        vc = VirtualClock()
        col = Collection("t", "c", D, sap_beta=beta, max_queue=1,
                         max_wait_ms=200.0, clock=vc, device="cpu")
        col.insert(ds.base[:50])
        user = col.new_user()
        q, t = user.encrypt_query(ds.queries[0])
        # the request sits in the queue until the (virtual) deadline, so
        # with max_queue=1 the second submit is shed deterministically
        fut = col.submit(q, t, K)
        with pytest.raises(QueueFullError):
            col.submit(q, t, K)
        vc.advance(0.21)                       # fire the deadline flush
        assert fut.result(timeout=30) is not None
        assert col.telemetry.snapshot()["n_rejected"] == 1
    finally:
        if col is not None:
            col.close()


# ------------------------------------------------- telemetry (port form)


def _tstats(nq=1, dist=0, cmp=0, scanned=0, up=0, down=0, backend="fake"):
    return SearchStats(latency_s=0.0, filter_dist_evals=dist,
                       refine_comparisons=cmp, bytes_up=up,
                       bytes_down=down, n_queries=nq, backend=backend,
                       filter_bytes_scanned=scanned)


# ---------------------------------------------------------- percentiles


def test_percentile_empty_reservoir_is_zero():
    assert CollectionTelemetry._percentile([], 0.50) == 0.0
    assert CollectionTelemetry._percentile([], 0.99) == 0.0


def test_percentile_single_sample_is_that_sample():
    assert CollectionTelemetry._percentile([0.25], 0.50) == 0.25
    assert CollectionTelemetry._percentile([0.25], 0.99) == 0.25


def test_percentile_interior_rank():
    xs = sorted(float(i) for i in range(101))      # 0..100
    assert CollectionTelemetry._percentile(xs, 0.50) == 50.0
    assert CollectionTelemetry._percentile(xs, 0.99) == 99.0
    assert CollectionTelemetry._percentile(xs, 1.00) == 100.0


# ----------------------------------------------------------- QPS window


def test_qps_counts_only_requests_inside_window():
    vc = VirtualClock()
    tel = CollectionTelemetry(window_s=10.0, clock=vc)
    tel.record_flush(4, [0.01] * 4, _tstats(nq=4), queue_depth=0)
    vc.advance(5.0)
    tel.record_flush(2, [0.01] * 2, _tstats(nq=2), queue_depth=0)
    # span is capped at the observed lifetime (5 s), not the window
    snap = tel.snapshot()
    assert snap["qps"] == (4 + 2) / 5.0


def test_qps_window_prunes_after_quiet_gap():
    """A long quiet gap must age old flushes out of the window even when
    no record_flush runs afterwards — snapshot() prunes on read."""
    vc = VirtualClock()
    tel = CollectionTelemetry(window_s=10.0, clock=vc)
    tel.record_flush(8, [0.01] * 8, _tstats(nq=8), queue_depth=0)
    vc.advance(100.0)                      # far past the 10 s window
    snap = tel.snapshot()
    assert snap["qps"] == 0.0
    assert len(tel._flushes) == 0          # actually pruned, not masked
    # fresh traffic after the gap counts alone, over the full window
    tel.record_flush(3, [0.01] * 3, _tstats(nq=3), queue_depth=0)
    assert tel.snapshot()["qps"] == 3 / 10.0


def test_fresh_collection_single_flush_does_not_explode_qps():
    vc = VirtualClock()
    tel = CollectionTelemetry(window_s=60.0, clock=vc)
    vc.advance(0.5)
    tel.record_flush(1, [0.001], _tstats(), queue_depth=0)
    assert tel.snapshot()["qps"] == 1 / 0.5


# ------------------------------------------------------- snapshot math


def test_snapshot_accumulates_search_stats_counters():
    """record_flush/record_step must SUM the engine's SearchStats cost
    counters across calls — not just remember the last backend."""
    vc = VirtualClock()
    tel = CollectionTelemetry(clock=vc)
    tel.record_flush(2, [0.01, 0.02],
                     _tstats(nq=2, dist=100, cmp=50, scanned=4096,
                            up=10, down=20, backend="flat"),
                     queue_depth=1)
    tel.record_step(3, 8, [0.03] * 3, [0.01] * 3,
                    _tstats(nq=3, dist=7, cmp=5, scanned=512,
                           up=1, down=2, backend="ivf"),
                    queue_depth=0)
    snap = tel.snapshot()
    assert snap["backend"] == "ivf"                # last engine call wins
    assert snap["filter_dist_evals"] == 107
    assert snap["refine_comparisons"] == 55
    assert snap["filter_bytes_scanned"] == 4608
    assert snap["bytes_up"] == 11
    assert snap["bytes_down"] == 22
    assert snap["n_batches"] == 1 and snap["n_steps"] == 1


def test_snapshot_latency_and_sojourn_reservoirs():
    vc = VirtualClock()
    tel = CollectionTelemetry(clock=vc)
    tel.record_flush(3, [0.01, 0.02, 0.03], _tstats(nq=3), queue_depth=0)
    tel.record_step(2, 4, [0.5], [0.1, 0.2], _tstats(nq=2),
                    queue_depth=0)
    # merged latency reservoir sorted: [0.01, 0.02, 0.03, 0.5]
    snap = tel.snapshot()
    assert snap["p50_latency_s"] == 0.03           # nearest-rank, n=4
    assert snap["p99_latency_s"] == 0.5            # step sojourns merge in
    assert snap["p50_insert_to_emit_s"] == 0.1
    assert snap["slot_occupancy"] == 0.5
    assert snap["batch_occupancy"] == 5 / 1        # batched reqs / flushes


def test_snapshot_counts_ingest_and_rejects():
    tel = CollectionTelemetry(clock=VirtualClock())
    tel.record_submit(queue_depth=3)
    tel.record_reject()
    tel.record_ingest(n_inserted=10)
    tel.record_ingest(n_deleted=2, compacted=True)
    snap = tel.snapshot()
    assert snap["n_requests"] == 1 and snap["n_rejected"] == 1
    assert snap["n_inserts"] == 10 and snap["n_deletes"] == 2
    assert snap["n_compactions"] == 1 and snap["queue_depth"] == 3


def test_telemetry_without_clock_uses_wall_time():
    tel = CollectionTelemetry()                    # no injected clock
    tel.record_flush(1, [0.01], _tstats(), queue_depth=0)
    assert tel.snapshot()["n_batches"] == 1


# ----------------------------------------------- metrics registry wiring


def test_metrics_registry_mirrors_counters():
    vc = VirtualClock()
    reg = MetricsRegistry()
    tel = CollectionTelemetry(clock=vc, metrics=reg,
                              labels={"tenant": "t", "collection": "c"})
    tel.record_submit(queue_depth=2)
    tel.record_flush(2, [0.01, 0.02],
                     _tstats(nq=2, dist=9, cmp=4, scanned=256, up=3,
                            down=6), queue_depth=0)
    lbl = {"tenant": "t", "collection": "c"}
    assert reg.get("ann_requests_total").value(**lbl) == 1
    assert reg.get("ann_batched_requests_total").value(**lbl) == 2
    assert reg.get("ann_filter_dist_evals_total").value(**lbl) == 9
    assert reg.get("ann_bytes_down_total").value(**lbl) == 6
    assert reg.get("ann_queue_depth").value(**lbl) == 0
    hist = reg.get("ann_request_latency_seconds")
    _, _, count = hist.snapshot(**lbl)
    assert count == 2
    text = reg.prometheus_text()
    assert 'ann_requests_total{tenant="t",collection="c"} 1' in text


def test_sharded_placement_not_ported_yet():
    """Sharded placement is ported now: a placement wider than the
    placement devices raises the reference's "device" error, an
    unresolved one is refused, and within the devices (here two logical
    ones on the host) the collection runs the sharded backend."""
    from repro_torch.launch.mesh import force_device_count

    class Placement:
        kind = "sharded"
        n_shards = 2
        n_replicas = 2
        data_axis = "data"

    with pytest.raises(ValueError, match="device"):
        Collection("t", "c", D, device="cpu", placement=Placement())
    force_device_count(2)
    try:
        col = Collection("t", "c", D, device="cpu", placement=Placement())
        assert col._backend.name == "sharded-flat"
        assert col.health.n_shards == 2 and col.health.n_replicas == 2
        assert col.shard_manifest() == [
            {"shard": s, "row_start": 0, "row_stop": 0, "n_alive": 0}
            for s in range(2)]
        col.close()
        Placement.n_shards = None
        with pytest.raises(ValueError, match="resolved"):
            Collection("t", "c", D, device="cpu", placement=Placement())
    finally:
        force_device_count(None)
