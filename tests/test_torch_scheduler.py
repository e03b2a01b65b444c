"""The port's schedulers (`repro_torch.serving.runtime`) under faults and
randomized interleavings: the cases of tests/test_scheduler_faults.py
and tests/test_scheduler_invariants.py in port form, on the CPU.

Fault injection against both serving schedulers (DESIGN.md §12, §16).

The liveness contract: a fault — the engine raising mid-step, a client
cancelling a request that is already being computed, `close()` landing
while a drain is in flight — never takes the scheduler down.  Under the
default `EngineRetryPolicy` a transient batch failure is recovered
per-request (each rider re-runs individually at an already-compiled
shape); under `max_attempts=1` the pre-resilience batch-wide failure is
restored.  Either way the scheduler thread survives, later requests are
served correctly, and nothing wedges.  A *poison* query — one that
fails every attempt — is quarantined alone: its batchmates still get
their results (the regression this file pins down).
"""

import threading
from concurrent.futures import CancelledError

import numpy as np
import pytest

from repro_torch.core import dcpe
from repro_torch.data import synth
from repro_torch.serving.runtime import (Collection, CollectionTelemetry,
                                         MicroBatcher, QueueFullError,
                                         SlotLoop, VirtualClock)
from repro_torch.serving.runtime.batcher import EngineRetryPolicy
from repro_torch.serving.search_engine import SearchStats

D = 18
K = 5
KINDS = ("flush", "continuous")

# restores the pre-resilience contract: a failed batch fails its riders
NO_RETRY = EngineRetryPolicy(max_attempts=1)


class FaultyEngine:
    """Deterministic ids (base = round(Q[i,0]), +arange(k)) with fault
    hooks: `fail_next` raises once; `poison` (a set of query bases)
    raises whenever a poisoned query rides the call — including its own
    retries; `in_call`/`gate` expose the window while a step computes."""

    def __init__(self):
        self.fail_next = False
        self.poison = set()
        self.in_call = threading.Event()
        self.gate = threading.Event()
        self.gate.set()
        self.n_calls = 0

    def __call__(self, Q, T, k, ratio_k=8.0, ef_search=96):
        self.in_call.set()
        try:
            self.gate.wait(timeout=10.0)
            self.n_calls += 1
            Q = np.atleast_2d(Q)
            base = np.round(Q[:, 0]).astype(np.int64)
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("injected engine fault")
            if self.poison & set(base.tolist()):
                raise RuntimeError("poison query fault")
            ids = base[:, None] + np.arange(k)[None, :]
            return ids, SearchStats(latency_s=0.0, filter_dist_evals=0,
                                    refine_comparisons=0, bytes_up=0,
                                    bytes_down=0, n_queries=Q.shape[0],
                                    backend="faulty")
        finally:
            self.in_call.clear()


def _mk(kind, eng, **kw):
    # real clock on purpose: these tests assert resolution and liveness,
    # never timing, and the flush deadline must fire on its own here
    kw.setdefault("max_batch", 4)
    if kind == "flush":
        return MicroBatcher(eng, max_wait_ms=5.0, **kw)
    return SlotLoop(eng, **kw)


def _req(i):
    return np.full(D, float(i), np.float32), np.zeros(2 * D + 16, np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_transient_fault_recovered_per_request(kind):
    """Default policy: a one-shot batch failure is invisible to the
    riders — each re-runs individually and resolves with exact ids."""
    eng = FaultyEngine()
    eng.gate.clear()
    with _mk(kind, eng) as sched:
        eng.fail_next = True
        futs = [sched.submit(*_req(i), K) for i in (1, 2)]
        eng.gate.set()
        for i, fut in zip((1, 2), futs):
            np.testing.assert_array_equal(fut.result(timeout=10),
                                          i + np.arange(K))
        assert sched.n_retries == 2          # one retry per rider
        assert sched.n_quarantined == 0
        if kind == "continuous":
            assert sched.n_active == 0


@pytest.mark.parametrize("kind", KINDS)
def test_poison_query_quarantined_alone(kind):
    """THE batch-blast regression: a query that fails every attempt is
    quarantined with its own exception; its batchmates still answer."""
    eng = FaultyEngine()
    eng.poison = {2}
    eng.gate.clear()
    with _mk(kind, eng) as sched:
        futs = {i: sched.submit(*_req(i), K) for i in (1, 2, 3)}
        eng.gate.set()
        with pytest.raises(RuntimeError, match="poison query fault"):
            futs[2].result(timeout=10)
        for i in (1, 3):                     # batchmates unharmed
            np.testing.assert_array_equal(futs[i].result(timeout=10),
                                          i + np.arange(K))
        assert sched.n_quarantined == 1
        # quarantine is terminal for that request only: new submits of
        # non-poison queries keep working
        np.testing.assert_array_equal(
            sched.submit(*_req(7), K).result(timeout=10), 7 + np.arange(K))


@pytest.mark.parametrize("kind", KINDS)
def test_engine_fault_fails_only_that_step_no_retry(kind):
    """max_attempts=1: the pre-resilience contract — a raising step
    fails exactly the futures riding it; the worker survives and the
    very next step succeeds (slots/buckets freed)."""
    eng = FaultyEngine()
    eng.gate.clear()
    with _mk(kind, eng, retry_policy=NO_RETRY) as sched:
        eng.fail_next = True
        doomed = [sched.submit(*_req(i), K) for i in (1, 2)]
        eng.gate.set()
        for fut in doomed:
            with pytest.raises(RuntimeError, match="injected engine fault"):
                fut.result(timeout=10)
        ok = sched.submit(*_req(3), K)          # scheduler still alive,
        np.testing.assert_array_equal(ok.result(timeout=10),
                                      3 + np.arange(K))
        if kind == "continuous":                # and its slots were freed
            assert sched.n_active == 0


@pytest.mark.parametrize("kind", KINDS)
def test_repeated_faults_never_wedge_the_scheduler(kind):
    eng = FaultyEngine()
    with _mk(kind, eng, retry_policy=NO_RETRY) as sched:
        for i in range(1, 6):
            eng.fail_next = True
            with pytest.raises(RuntimeError):
                sched.submit(*_req(i), K).result(timeout=10)
            good = sched.submit(*_req(10 + i), K).result(timeout=10)
            np.testing.assert_array_equal(good, 10 + i + np.arange(K))


@pytest.mark.parametrize("kind", KINDS)
def test_cancel_racing_emission(kind):
    """cancel() landing while the request's step is mid-computation: the
    emission path hits an already-cancelled future and must shrug it off
    — no InvalidStateError escapes, the next request is served."""
    eng = FaultyEngine()
    with _mk(kind, eng) as sched:
        for i in range(1, 8):                   # repeat: widen the race
            eng.gate.clear()
            fut = sched.submit(*_req(i), K)
            assert eng.in_call.wait(timeout=10)  # step is computing NOW
            fut.cancel()                         # race the emission
            eng.gate.set()
            ok = sched.submit(*_req(100 + i), K)
            np.testing.assert_array_equal(ok.result(timeout=10),
                                          100 + i + np.arange(K))
            assert fut.done()                    # cancelled or resolved,
            if not fut.cancelled():              # never leaked pending
                assert fut.result(timeout=0).shape == (K,)


@pytest.mark.parametrize("kind", KINDS)
def test_close_during_drain_serves_or_fails_never_wedges(kind):
    """close() while a step is wedged in the engine: the drain finishes
    once the engine returns, every accepted future resolves, close()
    returns, and later submits are rejected cleanly."""
    eng = FaultyEngine()
    eng.gate.clear()
    sched = _mk(kind, eng)
    futs = [sched.submit(*_req(i), K) for i in range(1, 7)]
    closer = threading.Thread(target=sched.close)
    closer.start()
    assert eng.in_call.wait(timeout=10)         # close raced a live step
    eng.gate.set()
    closer.join(timeout=30)
    assert not closer.is_alive(), "close() wedged during drain"
    for i, fut in enumerate(futs, start=1):
        assert fut.done()
        np.testing.assert_array_equal(fut.result(timeout=0),
                                      i + np.arange(K))
    with pytest.raises(RuntimeError):
        sched.submit(*_req(99), K)


@pytest.mark.parametrize("kind", KINDS)
def test_cancelled_requests_dropped_by_close(kind):
    """Requests still queued when close() lands are drained; requests a
    client discarded first stay cancelled — exactly-once either way."""
    eng = FaultyEngine()
    eng.gate.clear()
    sched = _mk(kind, eng, max_batch=1)
    kept = sched.submit(*_req(1), K)
    dropped = sched.submit(*_req(2), K)
    sched.discard(dropped)
    eng.gate.set()
    sched.close()
    np.testing.assert_array_equal(kept.result(timeout=0), 1 + np.arange(K))
    assert dropped.cancelled()
    with pytest.raises(CancelledError):
        dropped.result(timeout=0)


def test_retry_policy_validation():
    with pytest.raises(ValueError):
        EngineRetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        EngineRetryPolicy(backoff_s=-1.0)


@pytest.mark.parametrize("kind", KINDS)
def test_parity_assertion_never_retried(kind):
    """AssertionError is a deterministic bug (verify_parity), not a
    transient fault: no retry, the failure propagates immediately."""

    def bad_engine(Q, T, k, ratio_k=8.0, ef_search=96):
        raise AssertionError("parity mismatch")

    with _mk(kind, bad_engine) as sched:
        with pytest.raises(AssertionError, match="parity mismatch"):
            sched.submit(*_req(1), K).result(timeout=10)
        assert sched.n_retries == 0


# ---------------------------------------------------------------------------
# A real engine: inject a one-shot fault into the collection's _run_batch
# and require transparent recovery with exact ids (DESIGN.md §16: the
# fault is invisible to the client).  The sharded placement's fault
# recovery is in tests/test_torch_failover.py.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ds():
    return synth.make_dataset("sift1m", n=250, n_queries=5, k_gt=10,
                              seed=4, d=D)


@pytest.mark.parametrize("kind", KINDS)
def test_real_engine_fault_recovery(ds, kind):
    beta = dcpe.suggest_beta(ds.base, fraction=0.03)
    col = Collection("t", f"flt-{kind}", D, sap_beta=beta, seed=9,
                     scheduler=kind, max_batch=4, max_wait_ms=2.0,
                     device="cpu")
    try:
        col.insert(ds.base)
        col.compact()
        user = col.new_user()
        enc = [user.encrypt_query(q) for q in ds.queries]
        baseline = [col.search(*e, K) for e in enc]

        real = col.batcher._run_batch
        state = {"armed": True}

        def faulty(Q, T, k, **kw):
            if state["armed"]:
                state["armed"] = False
                raise RuntimeError("injected mid-stream fault")
            return real(Q, T, k, **kw)

        col.batcher._run_batch = faulty
        # default retry: the one-shot fault is recovered per-request —
        # the whole stream answers bit-identically to the baseline and
        # the client never sees the exception
        for e, want in zip(enc, baseline):
            np.testing.assert_array_equal(col.search(*e, K), want)
        assert col.telemetry.snapshot()["n_retries"] >= 1
    finally:
        col.close()


try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True

    def seeded(fn):
        """Drive the seeded-RNG test body with hypothesis-chosen seeds."""
        return settings(max_examples=15, deadline=None,
                        suppress_health_check=list(HealthCheck))(
            given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1))(fn))
except ImportError:                      # hypothesis not installed: the
    HAVE_HYPOTHESIS = False              # same program over fixed seeds

    def seeded(fn):
        return pytest.mark.parametrize("seed", range(12))(fn)


# ----------------------------------------------- randomized interleavings


class RecordingEngine:
    """Deterministic fake engine: ids[i] = 100*round(Q[i,0]) .. +k.

    Unique bases per request make assertion (2) exact: any cross-request
    row mixing shows up as a wrong id block.  The gate is the only
    synchronization — `_drive` uses it to stall a step mid-flight."""

    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self.calls = []

    def __call__(self, Q, T, k, ratio_k=8.0, ef_search=96):
        self.gate.wait(timeout=10.0)
        Q = np.atleast_2d(Q)
        self.calls.append(Q.shape)
        base = 100 * np.round(Q[:, 0]).astype(np.int64)
        ids = base[:, None] + np.arange(k)[None, :]
        return ids, SearchStats(latency_s=0.0, filter_dist_evals=0,
                                refine_comparisons=0, bytes_up=0,
                                bytes_down=0, n_queries=Q.shape[0],
                                backend="fake")


def _expected(i, k):
    return 100 * i + np.arange(k)


def _make_scheduler(kind, eng, clock, telemetry, max_batch, max_queue):
    if kind == "flush":
        return MicroBatcher(eng, max_batch=max_batch, max_queue=max_queue,
                            max_wait_ms=8.0, telemetry=telemetry,
                            clock=clock)
    return SlotLoop(eng, max_batch=max_batch, max_queue=max_queue,
                    telemetry=telemetry, clock=clock)


def _drive(kind, seed):
    """One randomized interleaving; returns nothing, asserts the contract."""
    rng = np.random.default_rng(seed)
    eng = RecordingEngine()
    clock = VirtualClock()
    tel = CollectionTelemetry()
    max_batch = int(rng.integers(1, 9))
    max_queue = int(rng.integers(1, 12))
    sched = _make_scheduler(kind, eng, clock, tel, max_batch, max_queue)
    accepted = []                       # (request index, future)
    done_counts = {}                    # id(fut) -> done-callback fires
    n_rejected = 0
    nxt = 1                             # request index 0 never used
    try:
        for _ in range(int(rng.integers(25, 60))):
            op = rng.choice(["submit", "submit", "submit", "submit",
                             "discard", "cancel", "advance", "stall"])
            if op == "submit":
                q = np.full(D, float(nxt), np.float32)
                t = np.zeros(2 * D + 16, np.float32)
                k = K if rng.random() < 0.7 else K + 2  # two param groups
                try:
                    fut = sched.submit(q, t, k)
                except QueueFullError:
                    n_rejected += 1
                else:
                    accepted.append((nxt, k, fut))
                    done_counts[id(fut)] = 0
                    fut.add_done_callback(
                        lambda f: done_counts.__setitem__(
                            id(f), done_counts[id(f)] + 1))
                nxt += 1
            elif op == "discard" and accepted:
                _, _, fut = accepted[int(rng.integers(len(accepted)))]
                sched.discard(fut)      # cancel + free the queue slot
            elif op == "cancel" and accepted:
                _, _, fut = accepted[int(rng.integers(len(accepted)))]
                fut.cancel()            # raw client-side cancel race
            elif op == "advance":
                clock.advance(float(rng.uniform(0.0, 0.02)))
            elif op == "stall":
                if eng.gate.is_set() and rng.random() < 0.5:
                    eng.gate.clear()    # wedge the next step mid-flight
                else:
                    eng.gate.set()
    finally:
        eng.gate.set()                  # release any wedged step, then
        sched.close()                   # drain everything deterministically

    for i, k, fut in accepted:
        assert fut.done(), f"request {i} never resolved"
        assert done_counts[id(fut)] == 1, \
            f"request {i} resolved {done_counts[id(fut)]} times"
        if fut.cancelled():
            continue                    # acknowledged cancellation
        try:
            ids = fut.result(timeout=0)
        except CancelledError:          # pragma: no cover - raced cancel
            continue
        np.testing.assert_array_equal(       # any mismatch here would be
            ids, _expected(i, k))            # cross-request row mixing
    assert tel.snapshot()["n_rejected"] == n_rejected


@pytest.mark.parametrize("kind", KINDS)
@seeded
def test_random_interleavings_uphold_contract(kind, seed):
    _drive(kind, seed)


@pytest.mark.parametrize("kind", KINDS)
def test_every_request_resolves_under_heavy_stall(kind):
    """Dense variant of the contract: a long stall while the queue fills
    past capacity, then one release — nothing lost, rejects counted."""
    eng = RecordingEngine()
    tel = CollectionTelemetry()
    sched = _make_scheduler(kind, eng, VirtualClock(), tel,
                            max_batch=3, max_queue=4)
    eng.gate.clear()
    accepted, n_rejected = [], 0
    try:
        for i in range(1, 30):
            try:
                accepted.append((i, sched.submit(
                    np.full(D, float(i), np.float32),
                    np.zeros(2 * D + 16, np.float32), K)))
            except QueueFullError:
                n_rejected += 1
        assert n_rejected > 0           # the stall really backed it up
    finally:
        eng.gate.set()
        sched.close()
    for i, fut in accepted:
        np.testing.assert_array_equal(fut.result(timeout=0),
                                      _expected(i, K))
    assert tel.snapshot()["n_rejected"] == n_rejected


# ---------------------------------------------------------------------------
# The same contract over a REAL collection: randomized submit / ingest /
# discard interleavings while the engine recompiles and deltas compact.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ds_mix():
    return synth.make_dataset("deep1m", n=300, n_queries=8, k_gt=10,
                              seed=2, d=D)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [3, 11])
def test_interleaved_ingest_and_search_on_real_collection(ds_mix, kind,
                                                         seed):
    ds = ds_mix
    rng = np.random.default_rng(seed)
    beta = dcpe.suggest_beta(ds.base, fraction=0.03)
    vc = VirtualClock()
    col = Collection("t", f"mix-{kind}-{seed}", D, sap_beta=beta, seed=1,
                     scheduler=kind, max_batch=4, max_queue=64,
                     max_wait_ms=5.0, compact_every=64, clock=vc,
                     device="cpu")
    try:
        col.insert(ds.base[:100])
        user = col.new_user()
        enc = [user.encrypt_query(q) for q in ds.queries]
        accepted, cursor = [], 100
        for _ in range(18):
            op = rng.choice(["submit", "submit", "insert", "advance",
                             "discard"])
            if op == "submit":
                fut = col.submit(*enc[int(rng.integers(len(enc)))], K)
                accepted.append(fut)
            elif op == "insert" and cursor < ds.n:
                step = int(rng.integers(1, 8))
                col.insert(ds.base[cursor:cursor + step])
                cursor += step
            elif op == "advance":
                vc.advance(float(rng.uniform(0.0, 0.01)))
            elif op == "discard" and accepted:
                col.batcher.discard(
                    accepted[int(rng.integers(len(accepted)))])
    finally:
        col.close()                     # drains every queued request
    n_total = col.store.n_total
    for fut in accepted:
        assert fut.done()
        if fut.cancelled():
            continue
        ids = fut.result(timeout=0)
        assert ids.shape == (K,)
        assert (ids < n_total).all()    # rows of THIS store only
        assert (ids >= 0).all()         # 100+ rows alive: no sentinels




# ---------------------------------------------------------------------------
# Cross-scheduler bit-identity on real engines: flat/ivf, through the
# collection's batch path and its coalesced per-request path.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["flat", "ivf"])
def test_schedulers_bit_identical_on_real_engines(ds_mix, backend):
    """For the same request stream, the flush micro-batcher and the
    continuous slot loop return bit-identical ids — batch path and
    coalesced per-request path."""
    ds = ds_mix
    beta = dcpe.suggest_beta(ds.base, fraction=0.05)
    extra = dict(n_partitions=8, nprobe=3) if backend == "ivf" else {}
    got = {}
    for sched in ("flush", "continuous"):
        col = Collection("t", f"par-{backend}-{sched}", D, sap_beta=beta,
                         seed=5, backend=backend, scheduler=sched,
                         max_batch=8, device="cpu", **extra)
        try:
            col.insert(ds.base)
            user = col.new_user()
            enc = [user.encrypt_query(q) for q in ds.queries]
            Q = np.stack([c for c, _ in enc])
            T = np.stack([t for _, t in enc])
            batch, _ = col.search_batch(Q, T, 8, ratio_k=6.0)
            futs = [col.submit(c, t, 8, ratio_k=6.0) for c, t in enc]
            coalesced = np.stack([f.result(timeout=30) for f in futs])
        finally:
            col.close()
        got[sched] = (batch, coalesced)
    np.testing.assert_array_equal(got["flush"][0], got["continuous"][0])
    np.testing.assert_array_equal(got["flush"][1], got["continuous"][1])
    np.testing.assert_array_equal(got["flush"][0], got["flush"][1])
