"""The port's flat engine against the JAX package's, on the CPU.

Setup of tests/test_search_engine.py (deep1m, n = 1200, 8 queries, seed
21), encrypted by the numpy path on both sides (bit-identical
ciphertexts).  The port runs with device="cpu", i.e. its plain PyTorch
versions; the JAX engine runs its Pallas kernels in interpret mode.  Ids
and the SearchStats counts must be equal.
"""

import numpy as np
import pytest
import torch

from repro.core import dcpe as jdcpe
from repro.core import ppanns as jppanns
from repro.core import secure_knn as jsecure_knn
from repro.data import synth
from repro.serving.search_engine import SecureSearchEngine as JEngine
from repro_torch.core import ppanns, secure_knn
from repro_torch.obs.trace import TraceRecorder
from repro_torch.serving.search_engine import (FlatScanFilter, SearchStats,
                                               SecureSearchEngine,
                                               refine_candidates)

K = 10
CPU = "cpu"
COUNTS = ("filter_dist_evals", "refine_comparisons", "bytes_up",
          "bytes_down", "filter_bytes_scanned", "n_queries", "backend")


@pytest.fixture(scope="module")
def setup():
    ds = synth.make_dataset("deep1m", n=1200, n_queries=8, k_gt=30, seed=21)
    beta = jdcpe.suggest_beta(ds.base, fraction=0.03)
    j_owner = jppanns.DataOwner(d=ds.d, sap_beta=beta, seed=21)
    t_owner = ppanns.DataOwner(d=ds.d, sap_beta=beta, seed=21)
    jdb = j_owner.encrypt_database(ds.base, build_index=False)
    tdb = t_owner.encrypt_database(ds.base, build_index=False)
    assert jdb.C_dce.tobytes() == tdb.C_dce.tobytes()
    user = ppanns.User(t_owner.share_keys())
    qs, ts = zip(*(user.encrypt_query(q) for q in ds.queries))
    Q, T = np.stack(qs), np.stack(ts)
    return (ds, JEngine(jdb.C_sap, jdb.C_dce, backend="flat"),
            SecureSearchEngine(tdb.C_sap, tdb.C_dce, device=CPU), Q, T)


def _same_counts(a, b):
    for f in COUNTS:
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("refine", ["tournament", "none"])
@pytest.mark.parametrize("ratio_k", [6, 8])
def test_batched_ids_and_stats_equal_jax(setup, refine, ratio_k):
    ds, jeng, teng, Q, T = setup
    want, wstats = jeng.search_batch(Q, T, K, ratio_k=ratio_k, refine=refine)
    got, gstats = teng.search_batch(Q, T, K, ratio_k=ratio_k, refine=refine)
    assert got.dtype == np.int64 and got.shape == (Q.shape[0], K)
    np.testing.assert_array_equal(got, want)
    assert isinstance(gstats, SearchStats) and gstats.latency_s > 0
    _same_counts(gstats, wstats)


@pytest.mark.parametrize("refine", ["tournament", "none", "heap"])
def test_per_query_ids_and_stats_equal_jax(setup, refine):
    ds, jeng, teng, Q, T = setup
    for qi in range(0, Q.shape[0], 3):
        want, wstats = jeng.search(Q[qi], T[qi], K, ratio_k=6, refine=refine)
        got, gstats = teng.search(Q[qi], T[qi], K, ratio_k=6, refine=refine)
        np.testing.assert_array_equal(got, want)
        _same_counts(gstats, wstats)
    assert gstats.bytes_up == 4 * ds.d + 4 * (2 * ds.d + 16) + 4
    assert gstats.bytes_down == 8 * K


def test_batched_matches_per_query(setup):
    ds, _, teng, Q, T = setup
    batched, _ = teng.search_batch(Q, T, K, ratio_k=6)
    for qi in range(Q.shape[0]):
        single, _ = teng.search(Q[qi], T[qi], K, ratio_k=6)
        np.testing.assert_array_equal(batched[qi], single)


def test_recall(setup):
    ds, _, teng, Q, T = setup
    ids, _ = teng.search_batch(Q, T, K, ratio_k=8)
    assert synth.recall_at_k(ids, ds.gt, K) >= 0.85


def test_underfilled_candidates_use_sentinel_not_id_zero():
    """k > n: -1 fill, never a fabricated id 0, and the same ids as the
    JAX flat engine for the tournament and filter-only modes."""
    rng = np.random.default_rng(3)
    P = rng.standard_normal((6, 16)).astype(np.float32)
    beta = jdcpe.suggest_beta(P, fraction=0.05)
    owner = ppanns.DataOwner(d=16, sap_beta=beta, seed=3)
    db = owner.encrypt_database(P, build_index=False)
    cq, tq = ppanns.User(owner.share_keys()).encrypt_query(P[4])
    teng = SecureSearchEngine(db.C_sap, db.C_dce, device=CPU)
    jeng = JEngine(db.C_sap, db.C_dce, backend="flat")
    for refine in ("tournament", "none"):
        ids, _ = teng.search(cq, tq, 10, refine=refine)
        want, _ = jeng.search(cq, tq, 10, refine=refine)
        np.testing.assert_array_equal(ids, want)
        assert ids.shape == (10,) and (ids[6:] == -1).all()
        real = ids[ids >= 0]
        assert len(set(real.tolist())) == len(real) == 6
    ids, _ = teng.search_batch(np.stack([cq, cq]), np.stack([tq, tq]), 10)
    assert ids.shape == (2, 10) and (ids[:, 6:] == -1).all()


def test_refine_candidates_masks_invalid_slots():
    rng = np.random.default_rng(0)
    owner = ppanns.DataOwner(d=8, sap_beta=1.0, seed=1)
    db = owner.encrypt_database(rng.standard_normal((20, 8)),
                                build_index=False)
    _, t = ppanns.User(owner.share_keys()).encrypt_query(
        rng.standard_normal(8))
    cand = torch.tensor([[3, 7, 0, 0], [1, 2, 4, 5]])
    valid = torch.tensor([[True, True, False, False], [True] * 4])
    out = refine_candidates(torch.as_tensor(db.C_dce), cand,
                            torch.as_tensor(np.stack([t, t])), valid, 3)
    assert out.shape == (2, 3)
    assert sorted(out[0, :2].tolist()) == [3, 7] and out[0, 2] == -1
    assert set(out[1].tolist()) <= {1, 2, 4, 5}


def test_update_database_reattaches(setup):
    ds, _, teng, Q, T = setup
    eng = SecureSearchEngine(teng._C_sap, teng._C_dce, device=CPU)
    eng.update_database(teng._C_sap[: ds.n - 1], teng._C_dce[: ds.n - 1])
    ids, _ = eng.search_batch(Q[:1], T[:1], K)
    assert eng.n == ds.n - 1 and (ids < ds.n - 1).all()


def test_filter_and_refine_spans_under_an_ambient_span(setup):
    ds, _, teng, Q, T = setup
    rec = TraceRecorder()
    teng.update_database(teng._C_sap, teng._C_dce)   # attach in the call
    with rec.span("flush", trace_id="b1"):
        teng.search_batch(Q[:2], T[:2], K, ratio_k=6)
    (root,) = rec.tree("b1")
    (eng,) = root["children"]
    assert eng["name"] == "engine.search_batch"
    names = [c["name"] for c in eng["children"]]
    assert names == ["engine.attach", "filter", "refine"]
    a, f, r = eng["children"]
    assert [c["name"] for c in a["children"]] == ["engine.upload",
                                                  "filter.attach"]
    assert a["children"][0]["attrs"]["bytes"] == teng._C_dce.nbytes
    assert f["attrs"]["backend"] == "flat" and f["attrs"]["kp"] == 60
    assert f["attrs"]["dist_evals"] == 2 * ds.n
    assert r["attrs"]["comparisons"] == 2 * 60 * 59


@pytest.mark.parametrize("kw,exc,match", [
    # every backend is ported now: what remains refused is refused with
    # the JAX package's ValueErrors (an unknown quantization, a
    # quantized graph string, the graphs the owner builds)
    ({"backend": "ivf", "quantization": "int4"}, ValueError, "int8|pq8"),
    ({"backend": "hnsw"}, ValueError, "HNSWGraphFilter"),
    ({"backend": "graph"}, ValueError, "GraphFilter"),
    ({"backend": "bogus", "quantization": "int8"}, ValueError, "flat|ivf")])
def test_later_slices_raise_not_implemented(kw, exc, match):
    C_sap = np.zeros((4, 8), np.float32)
    C_dce = np.zeros((4, 4, 32), np.float32)
    with pytest.raises(exc, match=match):
        SecureSearchEngine(C_sap, C_dce, device=CPU, **kw)


def test_backend_instance_accepted(setup):
    ds, jeng, teng, Q, T = setup
    eng = SecureSearchEngine(teng._C_sap, teng._C_dce,
                             backend=FlatScanFilter(chunk=256), device=CPU)
    want, _ = jeng.search_batch(Q, T, K, ratio_k=6)
    got, _ = eng.search_batch(Q, T, K, ratio_k=6)
    np.testing.assert_array_equal(got, want)


def test_secure_knn_refines_equal_jax(setup):
    ds, _, teng, Q, T = setup
    C = teng._C_dce
    rng = np.random.default_rng(2)
    cids = rng.choice(ds.n, 70, replace=False)
    for fn in ("refine_tournament", "refine_heap"):
        kw = {"device": CPU} if fn == "refine_tournament" else {}
        got = getattr(secure_knn, fn)(C[cids], cids, T[0], K, **kw)
        want = getattr(jsecure_knn, fn)(C[cids], cids, T[0], K)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    got = secure_knn.linear_scan_tournament(C[:300], T[1], K, chunk=128,
                                            device=CPU)
    want = jsecure_knn.linear_scan_tournament(C[:300], T[1], K, chunk=128)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    got = secure_knn.linear_scan_heap(C[:200], T[1], K)
    want = jsecure_knn.linear_scan_heap(C[:200], T[1], K)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


class _HookedBackend:
    """A stub filter backend with the engine's optional hooks: its own
    refine-array residency (`dce_device`), its own batched refine
    (`refine_batch`) and the failover fields.  `to_array` makes the
    hooks' arrays in either package (jnp or torch)."""

    name = "stub"

    def __init__(self, to_array, refine):
        self.to_array = to_array
        self.refine = refine
        self.calls = []
        self.last_filter_bytes = 7
        self.last_n_shards_down = 2
        self.last_degraded = True

    def dce_device(self, C_dce):
        self.calls.append("dce_device")
        return self.to_array(np.asarray(C_dce, np.float32))

    def attach(self, C_sap, engine):
        self.C_sap = np.asarray(C_sap, np.float32)

    def candidates(self, Q_sap, kp, ef_search):
        d = ((Q_sap[:, None, :] - self.C_sap[None]) ** 2).sum(-1)
        cand = np.argsort(d, axis=1, kind="stable")[:, :kp].astype(np.int32)
        return cand, np.ones(cand.shape, bool), d.size

    def refine_batch(self, C_dce_dev, cand, T, valid, k):
        self.calls.append("refine_batch")
        return self.refine(C_dce_dev, cand, T, valid, k)


def test_backend_hooks_and_failover_fields_equal_jax(setup):
    """The engine hands the refine array's residency and the refine
    itself to a backend that offers them, and reports the backend's
    shard-failover fields, in both packages alike."""
    import jax.numpy as jnp

    from repro.serving.search_engine import \
        refine_candidates as jrefine_candidates
    ds, _, teng, Q, T = setup
    jb = _HookedBackend(jnp.asarray, jrefine_candidates)
    tb = _HookedBackend(torch.from_numpy, refine_candidates)
    jeng = JEngine(teng._C_sap, teng._C_dce, backend=jb)
    eng = SecureSearchEngine(teng._C_sap, teng._C_dce, backend=tb,
                             device=CPU)
    want, wstats = jeng.search_batch(Q, T, K, ratio_k=6)
    got, gstats = eng.search_batch(Q, T, K, ratio_k=6)
    np.testing.assert_array_equal(got, want)
    _same_counts(gstats, wstats)
    assert (gstats.n_shards_down, gstats.degraded) == (2, True)
    assert (wstats.n_shards_down, wstats.degraded) == (2, True)
    assert tb.calls == jb.calls == ["dce_device", "refine_batch"]
    one, ostats = eng.search(Q[0], T[0], K, ratio_k=6, refine="heap")
    jone, jostats = jeng.search(Q[0], T[0], K, ratio_k=6, refine="heap")
    np.testing.assert_array_equal(one, jone)
    assert (ostats.n_shards_down, ostats.degraded) == \
        (jostats.n_shards_down, jostats.degraded) == (2, True)
