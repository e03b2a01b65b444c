"""The port's public API (`repro_torch.api`) against `repro.api`, on the
CPU (every service and owner encryption takes `device="cpu"`: the plain
PyTorch versions of the kernels).

Setup of tests/test_api.py (sift1m stand-in, n = 300, d = 16).  Held
exactly:
  * every protocol frame's bytes are equal across the two packages for
    the same content, each package's `from_bytes` reads the other's
    frames (and re-encodes them to the same bytes), and both refuse the
    same bad payloads with the same error;
  * with the same spec seed, `DataOwnerClient.encrypt_corpus` gives
    bit-identical ciphertexts and graph arrays, and `QueryClient(seed)`
    identical `EncryptedQuery` bytes; keystores cross between them;
  * the service's ids equal `repro`'s for every backend and the ADC
    quantizations, batch and coalesced, on identical ciphertexts;
  * `.ppcol` files cross-load both ways after the same insert and
    delete, with equal ids, and the two files' bytes are equal (numpy's
    zip writer stamps a fixed date, so equal content is equal bytes);
  * the legacy shims warn and match the typed path; sharded placement
    raises until it is ported; a `use_kernel=False` spec loads and
    serves with the same ids.
"""

import dataclasses

import numpy as np
import pytest

from repro import api as japi
from repro_torch import api
from repro_torch.api import (DataOwnerClient, EncryptedCorpus,
                             EncryptedQuery, IndexSpec, Keys, Keystore,
                             PlacementSpec, QueryClient, SearchParams,
                             SearchRequest, SearchResult, SecureAnnService,
                             WireFormatError, suggest_beta)
from repro_torch.core import ppanns
from repro_torch.core.wireformat import pack
from repro_torch.data import synth
from repro_torch.serving.search_engine import SearchStats, SecureSearchEngine

D = 16
N = 300
CPU = "cpu"
GRAPH_KW = dict(hnsw_M=8, hnsw_ef_construction=40)


@pytest.fixture(scope="module")
def ds():
    return synth.make_dataset("sift1m", n=N, n_queries=6, d=D, k_gt=10,
                              seed=0)


def _spec(mod, ds, backend="flat", name="col", **kw):
    return mod.IndexSpec(tenant="t", name=name, d=ds.d, backend=backend,
                         sap_beta=mod.suggest_beta(ds.base, fraction=0.05),
                         seed=5, **kw)


@pytest.fixture(scope="module")
def corpus(ds):
    """The owner's graph corpus (ciphertexts + HNSW arrays) and queries,
    made once by the port and fed to both packages."""
    owner = DataOwnerClient(_spec(api, ds, "graph", **GRAPH_KW))
    corpus = owner.encrypt_corpus(ds.base)
    query = owner.query_client(seed=21).encrypt_queries(ds.queries)
    extra = owner.encrypt_vectors(ds.base[:5], seed=77, device=CPU)
    return corpus, query, extra


def _as(mod, corpus, backend):
    """The corpus as `mod`'s EncryptedCorpus (the graph only where the
    backend walks one)."""
    index = corpus.index if backend in ("hnsw", "graph") else None
    return mod.EncryptedCorpus(C_sap=corpus.C_sap, C_dce=corpus.C_dce,
                               index=index)


def _request(mod, query, k=8, coalesce=False, name="col"):
    q = mod.EncryptedQuery(C_sap=query.C_sap, T=query.T)
    return mod.SearchRequest(tenant="t", collection=name, query=q,
                             params=mod.SearchParams(k=k, ratio_k=6.0),
                             coalesce=coalesce)


# ---------------------------------------------------------------------------
# Wire frames: equal bytes, read across, refused alike.
# ---------------------------------------------------------------------------

def _frames(mod, ds):
    """The same content as each protocol type of `mod`."""
    rng = np.random.default_rng(3)
    cdim = 2 * D + 16
    C_sap = rng.standard_normal((3, D)).astype(np.float32)
    T = rng.standard_normal((3, cdim)).astype(np.float32)
    C_dce = rng.standard_normal((3, 4, cdim)).astype(np.float32)
    index = {"levels": np.array([0, 1, 0], np.int32),
             "links0": rng.integers(-1, 3, (3, 4)).astype(np.int32)}
    query = mod.EncryptedQuery(C_sap=C_sap, T=T)
    stats = mod.SearchStats(latency_s=0.125, filter_dist_evals=10,
                            refine_comparisons=20, bytes_up=30,
                            bytes_down=40, n_queries=3, backend="graph",
                            filter_bytes_scanned=512, n_dummy_queries=1,
                            n_hops=7, n_edges_scanned=9, n_shards_down=1,
                            degraded=True)
    return {
        "placement-single": mod.PlacementSpec(),
        "placement-sharded": mod.PlacementSpec(kind="sharded", n_shards=2,
                                               n_replicas=2),
        "index-spec": _spec(mod, ds),
        "index-spec-adc": _spec(mod, ds, "ivf", quantization="int8",
                                refine_ratio=2.5, max_wait_ms=1.5,
                                scheduler="continuous", use_kernel=False,
                                security_profile="hardened"),
        "search-params": mod.SearchParams(k=7, ratio_k=4.0, ef_search=50),
        "encrypted-query": query,
        "encrypted-corpus": mod.EncryptedCorpus(C_sap=C_sap, C_dce=C_dce),
        "encrypted-corpus-index": mod.EncryptedCorpus(C_sap=C_sap,
                                                      C_dce=C_dce,
                                                      index=index),
        "search-request": mod.SearchRequest(
            tenant="t", collection="c", query=query,
            params=mod.SearchParams(k=7), coalesce=False),
        "search-request-trace": mod.SearchRequest(
            tenant="t", collection="c", query=query, trace_id="abc-1"),
        "search-result": mod.SearchResult(
            ids=np.array([[1, -1], [2, 3], [4, 5]]), stats=stats),
        "keys": mod.Keys.from_bytes(
            ppanns.DataOwner(d=17, sap_beta=2.0, seed=3).keys.to_bytes()),
    }


FRAMES = ["placement-single", "placement-sharded", "index-spec",
          "index-spec-adc", "search-params", "encrypted-query",
          "encrypted-corpus", "encrypted-corpus-index", "search-request",
          "search-request-trace", "search-result", "keys"]


@pytest.mark.parametrize("frame", FRAMES)
def test_frames_equal_bytes_and_read_across(ds, frame):
    mine, theirs = _frames(api, ds)[frame], _frames(japi, ds)[frame]
    data = mine.to_bytes()
    assert data == theirs.to_bytes()
    # each package decodes the other's frame to the same content
    assert type(mine).from_bytes(theirs.to_bytes()).to_bytes() == data
    assert type(theirs).from_bytes(data).to_bytes() == data


def _bad_payloads(mod, ds):
    spec = _spec(mod, ds).to_dict()
    cdim = 2 * D + 16
    q = {"C_sap": np.zeros((2, D), np.float32),
         "T": np.zeros((2, cdim), np.float32)}
    return {
        "garbage": (mod.IndexSpec, b"not an npz at all"),
        "kind": (mod.IndexSpec, mod.SearchParams().to_bytes()),
        "version": (mod.IndexSpec, pack("index-spec", 2, {}, spec)),
        "unknown-field": (mod.IndexSpec,
                          pack("index-spec", 1, {}, {**spec, "bogus": 1})),
        "bad-backend": (mod.IndexSpec, pack("index-spec", 1, {},
                                            {**spec, "backend": "annoy"})),
        "placement-field": (mod.PlacementSpec, pack(
            "placement-spec", 1, {}, {"kind": "single", "x": 1})),
        "placement-value": (mod.PlacementSpec, pack(
            "placement-spec", 1, {}, {"kind": "single", "n_shards": 4})),
        "query-dims": (mod.EncryptedQuery, pack(
            "encrypted-query", 1, {**q, "T": np.zeros((2, 7), np.float32)})),
        "corpus-shape": (mod.EncryptedCorpus, pack(
            "encrypted-corpus", 1, {"C_sap": q["C_sap"],
                                    "C_dce": np.zeros((2, 4, 7))})),
        "request-meta": (mod.SearchRequest,
                         pack("search-request", 1, q, {"tenant": "t"})),
        "result-stats": (mod.SearchResult, pack(
            "search-result", 1, {"ids": np.zeros((1, 2), np.int64)},
            {"stats": {"bogus": 1}})),
        "keys-version": (mod.Keys, pack("ppanns-keys", 2, {}, {})),
    }


@pytest.mark.parametrize("case", ["garbage", "kind", "version",
                                  "unknown-field", "bad-backend",
                                  "placement-field", "placement-value",
                                  "query-dims", "corpus-shape",
                                  "request-meta", "result-stats",
                                  "keys-version"])
def test_both_packages_refuse_the_same_payloads(ds, case):
    def refusal(cls, data):
        with pytest.raises(ValueError) as e:
            cls.from_bytes(data)
        return type(e.value).__name__, str(e.value)
    mine = refusal(*_bad_payloads(api, ds)[case])
    theirs = refusal(*_bad_payloads(japi, ds)[case])
    assert mine == theirs
    if case != "bad-backend":                # the spec's own ValueError
        assert mine[0] == "WireFormatError"


# ---------------------------------------------------------------------------
# Owner and user: identical ciphertexts, keys across packages.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["flat", "graph"])
def test_owner_and_user_match_the_jax_package(ds, backend):
    mine = DataOwnerClient(_spec(api, ds, backend, **GRAPH_KW))
    theirs = japi.DataOwnerClient(_spec(japi, ds, backend, **GRAPH_KW))
    assert mine.keys.to_bytes() == theirs.keys.to_bytes()
    a, b = mine.encrypt_corpus(ds.base), theirs.encrypt_corpus(ds.base)
    assert (a.index is None) == (backend == "flat")
    assert a.to_bytes() == b.to_bytes()            # C_sap, C_dce, graph
    ua, ub = mine.query_client(seed=9), theirs.query_client(seed=9)
    assert ua.encrypt_queries(ds.queries).to_bytes() == \
        ub.encrypt_queries(ds.queries).to_bytes()
    assert ua.encrypt_query(ds.queries[0]).to_bytes() == \
        ub.encrypt_query(ds.queries[0]).to_bytes()
    req_a = ua.request("t", "col", ds.queries[:2], k=5, ef_search=40)
    req_b = ub.request("t", "col", ds.queries[:2], k=5, ef_search=40)
    assert req_a.to_bytes() == req_b.to_bytes()


def test_from_keys_keeps_the_schedule_not_the_counter(ds):
    owner = ppanns.DataOwner(d=D, sap_beta=1.0, seed=4)
    a = ppanns.DataOwner.from_keys(owner.keys, seed=4)
    b = ppanns.DataOwner.from_keys(owner.keys, seed=4)
    db, da = (o.encrypt_database(ds.base[:20], build_index=False)
              for o in (owner, a))
    assert np.array_equal(db.C_sap, da.C_sap)
    assert np.array_equal(db.C_dce, da.C_dce)
    # the ingest counter restarts from entropy, never from the seed
    assert a._enc_ctr != b._enc_ctr and a._enc_ctr != owner._enc_ctr


def test_keystore_custody_across_packages(ds, tmp_path):
    spec, jspec = _spec(api, ds), _spec(japi, ds)
    store = Keystore(tmp_path / "ks")
    DataOwnerClient(spec).export_keys(store)
    japi.DataOwnerClient(dataclasses.replace(jspec, name="j")).export_keys(
        tmp_path / "ks")
    assert store.names() == japi.Keystore(tmp_path / "ks").names() == \
        ["t__col", "t__j"]
    for name in ("t__col", "t__j"):
        mine = store.load(name, expect_d=D)
        theirs = japi.Keystore(tmp_path / "ks").load(name, expect_d=D)
        assert mine.to_bytes() == theirs.to_bytes()
        qa = QueryClient.from_keystore(store, name, expect_d=D, seed=3)
        qb = japi.QueryClient.from_keystore(tmp_path / "ks", name,
                                            expect_d=D, seed=3)
        assert qa.encrypt_queries(ds.queries).to_bytes() == \
            qb.encrypt_queries(ds.queries).to_bytes()
    # an owner rebuilt from either package's keystore entry encrypts
    # like the JAX owner rebuilt from it (same keys, same seed schedule)
    a = DataOwnerClient.from_keystore(dataclasses.replace(spec, name="j"),
                                      store)
    b = japi.DataOwnerClient.from_keystore(
        dataclasses.replace(jspec, name="j"), tmp_path / "ks")
    assert a.encrypt_corpus(ds.base[:8]).to_bytes() == \
        b.encrypt_corpus(ds.base[:8]).to_bytes()
    with pytest.raises(WireFormatError):
        store.load("t__col", expect_d=D + 2)
    with pytest.raises(KeyError):
        store.load("nonexistent")
    with pytest.raises(ValueError):
        store.path("../escape")
    store.delete("t__j")
    assert store.names() == ["t__col"]


# ---------------------------------------------------------------------------
# The service: the same ids as repro.api's on the same ciphertexts.
# ---------------------------------------------------------------------------

CASES = [("flat", None), ("ivf", None), ("hnsw", None), ("graph", None),
         ("flat", "int8"), ("flat", "pq8")]


def _case_spec(mod, ds, backend, quant):
    kw = dict(GRAPH_KW)
    if backend == "ivf":
        kw.update(n_partitions=8, nprobe=3)
    if quant is not None:
        kw.update(quantization=quant, pq_m=4)
    return _spec(mod, ds, backend, name=f"{backend}-{quant}", **kw)


@pytest.mark.parametrize("backend,quant", CASES)
def test_service_ids_equal_the_jax_service(ds, corpus, backend, quant):
    enc, query, _ = corpus
    got = {}
    for mod, kw in ((api, {"device": CPU}), (japi, {})):
        spec = _case_spec(mod, ds, backend, quant)
        with mod.SecureAnnService(**kw) as svc:
            svc.create_collection(spec, _as(mod, enc, backend))
            batch = svc.submit(_request(mod, query, name=spec.name))
            ones = [svc.submit(_request(
                mod, dataclasses.replace(query, C_sap=query.C_sap[i:i + 1],
                                         T=query.T[i:i + 1]),
                coalesce=True, name=spec.name)).ids[0] for i in range(3)]
        got[mod] = (batch.ids, np.stack(ones), batch.stats)
    (ids, ones, stats), (jids, jones, jstats) = got[api], got[japi]
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(ones, jones)
    np.testing.assert_array_equal(ones, ids[:3])
    for f in ("filter_dist_evals", "refine_comparisons", "bytes_up",
              "bytes_down", "n_queries", "backend", "filter_bytes_scanned"):
        assert getattr(stats, f) == getattr(jstats, f), f
    assert synth.recall_at_k(ids, ds.gt, 8) > 0.3


def test_three_role_flow_matches_engine_exactly(ds, tmp_path):
    """Owner encrypts + exports keys; the service holds ciphertexts
    only; a user built from the keystore queries — ids must equal a
    directly-constructed SecureSearchEngine.search_batch."""
    spec = _spec(api, ds)
    owner = DataOwnerClient(spec)
    owner.export_keys(tmp_path / "keystore")
    C_sap, C_dce = owner.encrypt_vectors(ds.base, seed=11, device=CPU)
    user = QueryClient.from_keystore(tmp_path / "keystore", "t__col",
                                     expect_d=ds.d)
    query = user.encrypt_queries(ds.queries)
    params = SearchParams(k=8, ratio_k=6.0, ef_search=64)
    with SecureAnnService(device=CPU) as svc:
        assert svc.create_collection(spec) == spec
        svc.insert("t", "col", C_sap, C_dce)
        col = svc.collection("t", "col")
        with pytest.raises(RuntimeError, match="keyless"):
            col.insert(ds.base[:2])
        with pytest.raises(RuntimeError, match="keyless"):
            col.new_user()
        res = svc.submit(SearchRequest(tenant="t", collection="col",
                                       query=query, params=params,
                                       coalesce=False))
        res0 = svc.submit(SearchRequest(
            tenant="t", collection="col",
            query=user.encrypt_query(ds.queries[0]), params=params))
        with pytest.raises(api.TenantIsolationError):
            svc.submit(SearchRequest(tenant="other", collection="col",
                                     query=query))
        assert "observability disabled" in svc.metrics_text()
        assert svc.trace_events() == []
    engine = SecureSearchEngine(C_sap, C_dce, backend="flat", device=CPU)
    ids_ref, _ = engine.search_batch(query.C_sap, query.T, params.k,
                                     ratio_k=params.ratio_k,
                                     ef_search=params.ef_search)
    np.testing.assert_array_equal(res.ids, ids_ref)
    np.testing.assert_array_equal(res0.ids[0], ids_ref[0])
    assert res0.stats.n_queries >= 1
    assert synth.recall_at_k(res.ids, ds.gt, 8) > 0.6


def test_service_observability(ds, corpus):
    enc, query, _ = corpus
    with SecureAnnService(device=CPU, obs=True) as svc:
        svc.create_collection(_spec(api, ds), _as(api, enc, "flat"))
        svc.submit(_request(api, query))
        svc.submit(dataclasses.replace(
            _request(api, dataclasses.replace(query, C_sap=query.C_sap[:1],
                                              T=query.T[:1]),
                     coalesce=True), trace_id="req-7"))
        text = svc.metrics_text()
        events = svc.trace_events()
    assert "observability disabled" not in text and "ann_" in text
    assert any(e.get("trace_id") == "req-7" for e in events)


# ---------------------------------------------------------------------------
# Persistence: .ppcol files cross-load both ways.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,quant", [("flat", None), ("ivf", None),
                                           ("hnsw", None), ("graph", None),
                                           ("flat", "int8")])
def test_ppcol_cross_loads_both_ways(ds, corpus, tmp_path, backend, quant):
    enc, query, (x_sap, x_dce) = corpus
    ids, files = {}, {}
    for mod, kw, tag in ((api, {"device": CPU}, "torch"),
                         (japi, {}, "jax")):
        spec = _case_spec(mod, ds, backend, quant)
        req = _request(mod, query, name=spec.name)
        with mod.SecureAnnService(**kw) as svc:
            svc.create_collection(spec, _as(mod, enc, backend))
            svc.submit(req)        # the lazy filter-index build, NOW
            extra = svc.insert("t", spec.name, x_sap, x_dce)
            svc.delete("t", spec.name, [int(extra[0]), 3])
            ids[tag] = svc.submit(req).ids
            (files[tag],) = svc.save(tmp_path / tag)
    np.testing.assert_array_equal(ids["torch"], ids["jax"])
    assert 3 not in ids["torch"] and int(extra[0]) not in ids["torch"]
    assert files["torch"].name == files["jax"].name == \
        f"t__{backend}-{quant}.ppcol"
    assert files["torch"].read_bytes() == files["jax"].read_bytes()
    # the port loads repro's file, repro loads the port's
    for mod, kw, src in ((api, {"device": CPU}, "jax"),
                         (japi, {}, "torch")):
        spec = _case_spec(mod, ds, backend, quant)
        with mod.SecureAnnService.load(tmp_path / src, **kw) as svc:
            got = svc.submit(_request(mod, query, name=spec.name)).ids
            np.testing.assert_array_equal(got, ids["jax"])
            more = svc.insert("t", spec.name, enc.C_sap[:1], enc.C_dce[:1])
            assert svc.stats("t", spec.name)["n_total"] == N + 6
            assert int(more[0]) == N + 5


def test_load_missing_dir_fails(tmp_path):
    with pytest.raises(FileNotFoundError):
        SecureAnnService.load(tmp_path / "nothing-here", device=CPU)


def test_use_kernel_false_spec_loads_and_serves(ds, corpus, tmp_path):
    """`use_kernel` is a wire field only: the port never passes it on,
    and a spec (or a JAX package `.ppcol`) that carries False serves the
    same ids."""
    enc, query, _ = corpus
    spec = _spec(api, ds, use_kernel=False)
    assert "use_kernel" not in spec.collection_kwargs()
    assert IndexSpec.from_bytes(spec.to_bytes()).use_kernel is False
    with SecureAnnService(device=CPU) as svc:
        svc.create_collection(dataclasses.replace(spec, name="on",
                                                  use_kernel=True),
                              _as(api, enc, "flat"))
        want = svc.submit(_request(api, query, name="on")).ids
    jspec = _spec(japi, ds, use_kernel=False)
    with japi.SecureAnnService() as svc:
        svc.create_collection(jspec, _as(japi, enc, "flat"))
        svc.save(tmp_path)
    with SecureAnnService.load(tmp_path, device=CPU) as svc:
        got = svc.submit(_request(api, query)).ids
        (path,) = svc.save(tmp_path / "again")
    np.testing.assert_array_equal(got, want)
    assert path.read_bytes() == (tmp_path / "t__col.ppcol").read_bytes()


# ---------------------------------------------------------------------------
# Placement, legacy shims.
# ---------------------------------------------------------------------------

def test_sharded_placement_is_not_ported_yet(ds, corpus):
    enc, _, _ = corpus
    sharded = PlacementSpec(kind="sharded", n_shards=1)
    assert PlacementSpec.from_bytes(sharded.to_bytes()) == sharded
    assert sharded.resolve(4) == sharded
    assert PlacementSpec(kind="sharded").resolve(2).n_shards == 2
    with pytest.raises(ValueError, match="only 1 device"):
        PlacementSpec(kind="sharded", n_shards=2).resolve(1)
    with SecureAnnService(device=CPU) as svc:
        with pytest.raises(ValueError, match="cannot be sharded"):
            svc.create_collection(_spec(api, ds, "hnsw"), placement=sharded)
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            svc.create_collection(_spec(api, ds), _as(api, enc, "flat"),
                                  placement=sharded)
        # nothing was created under the name
        with pytest.raises(api.TenantIsolationError):
            svc.collection("t", "col")
        svc.create_collection(_spec(api, ds))
        assert svc.placement("t", "col") == PlacementSpec()


def test_shims_warn_and_match_new_path(ds):
    beta = suggest_beta(ds.base, fraction=0.05)
    with pytest.warns(DeprecationWarning, match="repro_torch.api"):
        owner_l, user_l, server = ppanns.build_system(
            ds.base, beta=beta, s=1024.0, seed=3, device=CPU)
    spec = IndexSpec(tenant="t", name="parity", d=ds.d, backend="hnsw",
                     sap_beta=beta, seed=3)
    owner = DataOwnerClient(spec)
    enc = owner.encrypt_corpus(ds.base)
    # same seed schedule => byte-identical outsourced database
    assert np.array_equal(enc.C_sap, np.asarray(server.db.C_sap))
    assert np.array_equal(enc.C_dce, np.asarray(server.db.C_dce))
    user = owner.query_client()
    params = SearchParams(k=7, ratio_k=8.0, ef_search=96)
    with SecureAnnService(device=CPU) as svc:
        svc.create_collection(spec, corpus=enc)
        for q in ds.queries[:3]:
            eq = user.encrypt_query(q)
            with pytest.warns(DeprecationWarning, match="repro_torch.api"):
                ids_legacy, _ = server.search(eq.C_sap[0], eq.T[0], 7)
            res = svc.submit(SearchRequest(tenant="t", collection="parity",
                                           query=eq, params=params))
            np.testing.assert_array_equal(res.ids[0], ids_legacy)
        eq = user.encrypt_queries(ds.queries)
        ids_lb, _ = server.search_batch(eq.C_sap, eq.T, 7)
        res = svc.submit(SearchRequest(tenant="t", collection="parity",
                                       query=eq, params=params,
                                       coalesce=False))
        np.testing.assert_array_equal(res.ids, ids_lb)


def test_result_roundtrip_and_postprocess():
    stats = SearchStats(latency_s=0.5, filter_dist_evals=10,
                        refine_comparisons=20, bytes_up=30, bytes_down=40,
                        n_queries=3, backend="flat")
    res = SearchResult(ids=np.array([[1, -1], [2, 3], [4, 5]]), stats=stats)
    res2 = SearchResult.from_bytes(res.to_bytes())
    assert np.array_equal(res2.ids, res.ids) and res2.ids.dtype == np.int64
    assert res2.stats == stats and not res2.degraded
    assert [list(x) for x in QueryClient.postprocess(res2)] == \
        [[1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="trapdoors"):
        EncryptedQuery(C_sap=np.zeros((2, D), np.float32),
                       T=np.zeros((3, 2 * D + 16), np.float32))
    with pytest.raises(ValueError, match="refine"):
        SearchParams(k=5, refine="heap")
    assert Keys is ppanns.Keys and EncryptedCorpus.__module__ == \
        "repro_torch.api.protocol"
