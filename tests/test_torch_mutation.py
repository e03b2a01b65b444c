"""The port's live ingestion (`repro_torch.serving.runtime.ingest` and
`collections`) against the JAX package's, on the CPU.

Both packages get identical ciphertexts: the numpy `encrypt_database`
rows (bit-identical in both packages), the reference `User`'s queries,
and for the graph kinds one owner-built HNSW (`to_arrays()`, loaded by
`load_snapshot`).  Keyless collections then run the same insert, delete
and compact sequence.  Ids, the `SearchStats` counts and
`MutableEncryptedStore.state_digest()` must be equal, and no deleted id
may come back.  The JAX package runs its XLA paths (what it serves off
a TPU); the port runs its plain PyTorch versions (`device="cpu"`).

The second half holds the cases of tests/test_mutation.py in port form,
and the port's own device residency: the incremental uploads inside a
capacity bucket are bit-equal to a full upload, written in place.
"""

import numpy as np
import pytest
import torch

from repro.core import ppanns as jppanns
from repro.core.hnsw import HNSW as JHNSW
from repro.serving.runtime import Collection as JCollection
from repro_torch.core import dcpe, ppanns
from repro_torch.core.hnsw import HNSW
from repro_torch.data import synth
from repro_torch.serving.runtime import Collection, DeltaAwareBackend

K = 10
D = 32
N0 = 300                    # rows loaded by snapshot; the rest inserted
COUNTS = ("filter_dist_evals", "refine_comparisons", "filter_bytes_scanned",
          "bytes_up", "bytes_down", "n_queries", "backend", "n_hops",
          "n_edges_scanned", "n_shards_down", "degraded")
HNSW_KW = dict(hnsw_M=8, hnsw_ef_construction=48)
# every kind x quantization the reference allows, and its oblivious tiers
CASES = [("flat", None, False), ("flat", "int8", False),
         ("flat", "pq8", False), ("ivf", None, False),
         ("ivf", "int8", False), ("ivf", "pq8", False),
         ("hnsw", None, False), ("graph", None, False),
         ("graph", "int8", False), ("graph", "pq8", False),
         ("ivf", None, True), ("ivf", "int8", True), ("graph", None, True)]


@pytest.fixture(scope="module")
def corpus():
    ds = synth.make_dataset("deep1m", n=380, n_queries=8, k_gt=K, seed=3,
                            d=D)
    beta = dcpe.suggest_beta(ds.base, 0.03)
    db = ppanns.DataOwner(d=D, sap_beta=beta, seed=3).encrypt_database(
        ds.base, build_index=False)
    user = jppanns.User(jppanns.DataOwner(d=D, sap_beta=beta,
                                          seed=3).share_keys())
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    graph = HNSW(D, M=HNSW_KW["hnsw_M"],
                 ef_construction=HNSW_KW["hnsw_ef_construction"],
                 seed=5).build(db.C_sap[:N0]).to_arrays()
    return ds, db.C_sap, db.C_dce, Q, T, graph


def _kw(kind, quant, oblivious):
    kw = dict(backend=kind, keyless=True, seed=5, compact_every=10_000)
    if quant is not None:
        kw["quantization"] = quant
    if quant == "pq8":
        kw["pq_m"] = 4                      # 8-dim subspaces: cheap k-means
    if oblivious:
        kw["oblivious"] = True
    if kind == "ivf":
        kw.update(n_partitions=8, nprobe=3)
    if kind in ("hnsw", "graph"):
        kw.update(HNSW_KW)
    return kw


DELETES = ([1, 5, 9, 33], [305, 2, 150])


def _run_sequence(col, corpus, ratio_k=8):
    """snapshot load -> delete -> insert burst -> search -> compact ->
    delete (main and promoted rows) -> insert -> search."""
    _, C_sap, C_dce, Q, T, graph = corpus
    graph_kw = ({"graph_arrays": graph}
                if col._backend.kind in ("hnsw", "graph") else {})
    col.load_snapshot(C_sap[:N0], C_dce[:N0], **graph_kw)
    col.delete(DELETES[0])
    col.insert_encrypted(C_sap[N0:340], C_dce[N0:340])
    first = col.search_batch(Q, T, K, ratio_k=ratio_k)
    col.compact()
    col.delete(DELETES[1])
    col.insert_encrypted(C_sap[340:], C_dce[340:])
    second = col.search_batch(Q, T, K, ratio_k=ratio_k)
    return first, second


@pytest.mark.parametrize("kind,quant,oblivious", CASES)
def test_collection_parity_with_jax_after_mutations(corpus, kind, quant,
                                                    oblivious):
    kw = _kw(kind, quant, oblivious)
    jcol = JCollection("t", "c", D, **kw)
    tcol = Collection("t", "c", D, device="cpu", **kw)
    try:
        want = _run_sequence(jcol, corpus)
        got = _run_sequence(tcol, corpus)
        for (wids, wst), (gids, gst) in zip(want, got):
            np.testing.assert_array_equal(gids, wids)
            for f in COUNTS:
                assert getattr(gst, f) == getattr(wst, f), f
        assert tcol.store.state_digest() == jcol.store.state_digest()
        deleted = DELETES[0] + DELETES[1]
        assert not np.isin(got[1][0], deleted).any()
        assert not np.isin(got[0][0], DELETES[0]).any()
        assert (got[1][0] >= 0).all()
        snap = tcol.stats()
        assert snap["n_deletes"] == len(deleted)
        assert snap["n_inserts"] == corpus[1].shape[0]
    finally:
        jcol.close()
        tcol.close()


@pytest.mark.parametrize("kind,quant", [("flat", None), ("ivf", "int8"),
                                        ("graph", None), ("graph", "pq8")])
def test_flush_continuous_and_direct_ids_equal(corpus, kind, quant):
    """The same mutated collection served through the flush
    micro-batcher, the continuous slot loop and the direct engine path
    returns the same ids for every query."""
    _, C_sap, C_dce, Q, T, _ = corpus
    got = {}
    for sched in ("flush", "continuous"):
        col = Collection("t", f"c-{sched}", D, device="cpu",
                         scheduler=sched, max_batch=4, max_wait_ms=1.0,
                         **_kw(kind, quant, False))
        try:
            _run_sequence(col, corpus)
            direct, _ = col.search_batch(Q, T, K)
            futs = [col.submit(q, t, K) for q, t in zip(Q, T)]
            via = np.stack([f.result(timeout=60) for f in futs])
        finally:
            col.close()
        np.testing.assert_array_equal(via, direct)
        got[sched] = via
    np.testing.assert_array_equal(got["flush"], got["continuous"])


def test_hnsw_delete_bursts_bit_identical_to_jax():
    """The port's delete finds in-neighbours in a padded index kept across
    a burst; interleaved with inserts (which drop it), the graph, the
    repaired rows and the distance-evaluation count stay those of the JAX
    package's full scan."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((700, 16)).astype(np.float32)
    dels = rng.permutation(600)[:80].tolist()
    out = []
    for cls in (JHNSW, HNSW):
        h = cls(16, M=6, ef_construction=30, seed=1).build(X[:600])
        rep = []
        for i, node in enumerate(dels):
            rep.append(h.delete(node))
            if i == 40:                     # an insert burst mid-way
                for x in X[600:650]:
                    h.insert(x)
        for x in X[650:]:
            h.insert(x)
        rep.append(h.delete(620))
        out.append((h.to_arrays(), h.n_dist_evals, rep))
    (ja, jn, jrep), (ta, tn, trep) = out
    assert tn == jn and trep == jrep
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


# ------------------------------------------- device residency in place


def _fresh_backend(col, kind, quant):
    """A second backend over the same store, attached once: what a full
    upload of the current state holds."""
    kw = {k: v for k, v in _kw(kind, quant, False).items()
          if k in ("n_partitions", "nprobe", "hnsw_M",
                   "hnsw_ef_construction", "quantization", "pq_m")}
    b = DeltaAwareBackend(col.store, kind, device="cpu", seed=5, **kw)
    if kind == "graph":
        b.graph = col._backend.graph
    b.dce_device(col.store.dce_padded_view)
    if quant is not None:
        b.restore_adc(col._backend.adc_codebook,
                      col._backend.adc_trained_gen)
    b.attach(col.store.sap_view, None)
    return b


@pytest.mark.parametrize("kind,quant", [("flat", None), ("ivf", None),
                                        ("flat", "int8"), ("flat", "pq8"),
                                        ("graph", None)])
def test_incremental_uploads_bit_equal_to_full_upload(corpus, kind, quant):
    """Insert bursts inside a capacity bucket are copied into the device
    tensors already held (same storage), and every tensor then equals a
    full upload of the same store bit for bit; crossing the bucket
    allocates fresh tensors."""
    _, C_sap, C_dce, Q, T, graph = corpus
    col = Collection("t", "c", D, device="cpu", **_kw(kind, quant, False))
    try:
        b = col._backend
        graph_kw = {"graph_arrays": graph} if kind == "graph" else {}
        col.load_snapshot(C_sap[:N0], C_dce[:N0], **graph_kw)
        col.search_batch(Q[:2], T[:2], K)
        held = {"dce": b._C_dce_dev.data_ptr()}
        for lo, hi in ((N0, 310), (310, 340), (340, 360)):
            col.insert_encrypted(C_sap[lo:hi], C_dce[lo:hi])
            col.search_batch(Q[:2], T[:2], K)
            assert b._C_dce_dev.data_ptr() == held["dce"]   # in place
        full = _fresh_backend(col, kind, quant)
        n = col.store.n_total
        assert torch.equal(b._C_dce_dev, full._C_dce_dev)
        names = {"flat": ["_C_main", "_C_delta"], "ivf": ["_C_all"],
                 "graph": ["_C_all", "_g_neigh0", "_g_neigh_up", "_g_ok"]}
        names = names[kind] if quant is None else ["_adc_ok"]
        for name in names:
            assert torch.equal(getattr(b, name), getattr(full, name)), name
        if quant is not None:       # c8 and cn, or the (m, n) PQ codes
            assert len(b.codes.arrays) == (2 if quant == "int8" else 1)
            for got, want in zip(b.codes.arrays, full.codes.arrays):
                assert torch.equal(got, want)
        # the next burst crosses the 512-row bucket: a fresh tensor
        col.insert_encrypted(np.repeat(C_sap[:1], 512 - n + 1, 0),
                             np.repeat(C_dce[:1], 512 - n + 1, 0))
        col.search_batch(Q[:2], T[:2], K)
        assert b._C_dce_dev.shape[0] == 1024
        assert torch.equal(b._C_dce_dev,
                           torch.from_numpy(col.store.dce_padded_view))
    finally:
        col.close()


def test_tombstoned_rows_keep_stale_device_rows_but_never_return(corpus):
    _, C_sap, C_dce, Q, T, _ = corpus
    col = Collection("t", "c", D, device="cpu", **_kw("flat", None, False))
    try:
        col.load_snapshot(C_sap[:N0], C_dce[:N0])
        ids, _ = col.search_batch(Q, T, K)
        victims = np.unique(ids[:, :3])
        col.delete(victims)
        after, _ = col.search_batch(Q, T, K)
        assert not np.isin(after, victims).any()
        assert (col.store.dce_view[victims] == 0).all()        # scrubbed
        alive = col.store.alive_view
        dev = col._backend._C_dce_dev[: col.store.n_total]
        assert torch.equal(dev[alive], torch.from_numpy(
            col.store.dce_view[alive]))
    finally:
        col.close()


# ------------------------------------------ tests/test_mutation.py, port


# the hnsw kind (the per-query host walk) is held above, against the
# JAX package; its host inserts are the costly part of these cases
BACKENDS = ["flat", "ivf", "graph"]


@pytest.fixture(scope="module")
def ds():
    return synth.make_dataset("deep1m", n=700, n_queries=10, k_gt=30,
                              seed=11, d=D)


def _collection(ds, backend, **kw):
    beta = dcpe.suggest_beta(ds.base, fraction=0.03)
    kw.setdefault("compact_every", 10_000)     # explicit compaction only
    if backend == "ivf":
        kw.setdefault("n_partitions", 16)
        kw.setdefault("nprobe", 8)
    if backend in ("hnsw", "graph"):      # a sparser graph than the
        kw.setdefault("hnsw_M", 8)          # reference test's M 12 /
        kw.setdefault("hnsw_ef_construction", 40)   # efC 100: host inserts
                                                    # dominate the time
    return Collection("t0", "c0", ds.d, backend=backend, sap_beta=beta,
                      seed=11, device="cpu", **kw)


def _enc_queries(col, queries):
    user = col.new_user()
    qs, ts = zip(*(user.encrypt_query(q) for q in queries))
    return np.stack(qs), np.stack(ts)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mutation_semantics_per_backend(ds, backend):
    """Searches issued after insert/delete see inserts immediately and
    never return deleted ids — across every filter backend."""
    col = _collection(ds, backend)
    try:
        col.insert(ds.base[:600])
        Q, T = _enc_queries(col, ds.queries)
        # a planted duplicate of query 0 must be returned as a neighbor
        new = col.insert(ds.queries[0][None])
        ids, _ = col.search_batch(Q[:1], T[:1], K, ratio_k=8, ef_search=128)
        assert new[0] in ids[0], (backend, new, ids)
        # delete it (plus a true neighbor): neither may ever come back
        victim = int(ds.gt[1, 0])
        col.delete([int(new[0]), victim])
        ids2, _ = col.search_batch(Q[:4], T[:4], K, ratio_k=8,
                                   ef_search=128)
        assert not np.isin(ids2, [int(new[0]), victim]).any(), backend
        # surviving results still have high recall
        rec = synth.recall_at_k(ids2, ds.gt[:4], K)
        assert rec >= 0.7, (backend, rec)
    finally:
        col.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_parity_after_mutation_sequence(ds, backend):
    """Looped batch-of-one == batched, exactly, after a mutation sequence
    (insert burst, deletes, second insert burst, compaction)."""
    col = _collection(ds, backend)
    try:
        col.insert(ds.base[:500])
        col.delete(np.arange(0, 40, 4))
        col.insert(ds.base[500:640])
        col.delete(np.arange(520, 540, 3))
        col.compact()
        col.insert(ds.base[640:700])          # fresh delta after compact
        Q, T = _enc_queries(col, ds.queries)
        batched, stats = col.search_batch(Q, T, K, ratio_k=6)
        assert stats.backend == backend
        for qi in range(Q.shape[0]):
            single, _ = col.search_batch(Q[qi: qi + 1], T[qi: qi + 1], K,
                                         ratio_k=6)
            np.testing.assert_array_equal(batched[qi], single[0],
                                          err_msg=f"{backend} q{qi}")
    finally:
        col.close()


@pytest.mark.parametrize("backend", ["flat", "ivf"])
def test_compaction_preserves_results(ds, backend):
    """Promoting delta -> main changes acceleration state, not answers
    (flat exactly; IVF up to probe-set drift, bounded by recall)."""
    col = _collection(ds, backend)
    try:
        col.insert(ds.base[:400])
        col.compact()
        col.insert(ds.base[400:650])          # large live delta
        col.delete([5, 405])
        Q, T = _enc_queries(col, ds.queries)
        before, _ = col.search_batch(Q, T, K, ratio_k=8, ef_search=128)
        col.compact()
        after, _ = col.search_batch(Q, T, K, ratio_k=8, ef_search=128)
        if backend == "flat":
            for b, a in zip(before.tolist(), after.tolist()):
                assert set(b) == set(a)
        else:
            rec = synth.recall_at_k(after, ds.gt, K)
            assert rec >= 0.7, rec
        assert not np.isin(after, [5, 405]).any()
    finally:
        col.close()


def test_delete_unknown_id_raises(ds):
    col = _collection(ds, "flat")
    try:
        col.insert(ds.base[:20])
        with pytest.raises(KeyError):
            col.delete([100])
        col.delete([3])
        with pytest.raises(KeyError):          # double delete
            col.delete([3])
    finally:
        col.close()


def test_delete_batch_with_bad_id_is_atomic(ds):
    """A batch containing one invalid id mutates nothing, and the
    collection keeps serving correct results afterwards."""
    col = _collection(ds, "flat")
    try:
        col.insert(ds.base[:200])
        col.compact()
        Q, T = _enc_queries(col, ds.queries[:2])
        victim = int(ds.gt[0, 0])
        with pytest.raises(KeyError):
            col.delete([victim, 999_999])       # second id is bogus
        assert col.store.n_alive == 200         # nothing was tombstoned
        ids, _ = col.search_batch(Q, T, K, ratio_k=8, ef_search=128)
        assert victim in ids[0]                 # victim survived intact
        with pytest.raises(KeyError):
            col.delete([victim, victim])        # duplicate in one batch
        assert col.store.alive_view[victim]
    finally:
        col.close()


def test_flat_delta_candidates_are_globally_distance_sorted(ds):
    """The engine's refine="none" baseline takes cand[:, :k] directly,
    so the flat backend must merge its main and delta scan blocks by
    distance — a delta row nearer than the k-th main row has to appear
    in the first k columns."""
    col = _collection(ds, "flat")
    try:
        col.insert(ds.base[:300])
        col.compact()
        planted = col.insert(ds.queries[0][None])   # delta: exact match
        user = col.new_user()
        cq, tq = user.encrypt_query(ds.queries[0])
        ids, _ = col._engine.search(cq, tq, K, ratio_k=8, refine="none")
        assert planted[0] in ids, ids
    finally:
        col.close()


def test_ivf_recovers_after_base_region_fully_deleted(ds):
    """Tombstoning every row in the built region must not blind the IVF
    backend to later inserts."""
    col = _collection(ds, "ivf")
    try:
        first = col.insert(ds.base[:64])
        col.compact()
        Q, T = _enc_queries(col, ds.queries[:1])
        col.search_batch(Q, T, K)               # builds ivf over main
        col.delete(first)                       # kill the whole base
        planted = col.insert(ds.queries[0][None])
        ids, _ = col.search_batch(Q, T, K, ratio_k=8)
        assert planted[0] in ids[0]
        assert not np.isin(ids, first).any()
    finally:
        col.close()
