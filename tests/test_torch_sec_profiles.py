"""The port's security profiles (`repro_torch.sec`, DESIGN.md §14): the
registry equal to the JAX package's, dummy-query accounting in the
schedulers, and the acceptance bar — returned real ids bit-identical to
`perf` under `balanced` and `hardened`, across both schedulers and f32,
quantized and graph filters — and, through `repro_torch.api`, the
IndexSpec wire round trip and validation, the result-width padding and
its accounting: the cases of tests/test_sec_profiles.py in port form on
the CPU (all but the sharded one: sharded placement is not ported yet).
"""

import dataclasses

import numpy as np
import pytest

from repro import api as japi
from repro import sec as jsec
from repro_torch import sec
from repro_torch.api import (DataOwnerClient, IndexSpec, SearchParams,
                             SearchRequest, SearchResult, SecureAnnService)
from repro_torch.core import dcpe, ppanns
from repro_torch.core.hnsw import HNSW
from repro_torch.data import synth
from repro_torch.sec import (DEFAULT_PROFILE, PROFILES,
                             SECURITY_PROFILE_NAMES, SecurityProfile,
                             get_profile)
from repro_torch.serving.runtime import Collection

D = 16
N = 400
K = 8


@pytest.fixture(scope="module")
def corpus():
    ds = synth.make_dataset("sift1m", n=N, n_queries=6, d=D, k_gt=10,
                            seed=0)
    beta = dcpe.suggest_beta(ds.base, fraction=0.05)
    owner = ppanns.DataOwner(d=D, sap_beta=beta, seed=5)
    db = owner.encrypt_database(ds.base, build_index=False)
    user = ppanns.User(owner.share_keys())
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    graph = HNSW(D, M=8, ef_construction=32, seed=6).build(
        db.C_sap).to_arrays()
    return db.C_sap, db.C_dce, Q, T, graph


def _collection(corpus, profile, kind, quant, scheduler):
    C_sap, C_dce, _, _, graph = corpus
    kw = dict(n_partitions=8, nprobe=3) if kind == "ivf" else {}
    if kind == "graph":
        kw.update(hnsw_M=8, hnsw_ef_construction=32)
    if quant == "pq8":
        kw["pq_m"] = 4                      # 4-dim subspaces: cheap k-means
    col = Collection("t", f"{profile}-{kind}", D, device="cpu",
                     keyless=True, seed=5, backend=kind, quantization=quant,
                     scheduler=scheduler, max_batch=8, max_wait_ms=1.0,
                     security_profile=profile, **kw)
    col.load_snapshot(C_sap, C_dce,
                      graph_arrays=graph if kind == "graph" else None)
    return col


# ---------------------------------------------------------------------------
# Registry + result-width semantics.
# ---------------------------------------------------------------------------

def test_profile_registry_equals_the_jax_package():
    assert SECURITY_PROFILE_NAMES == jsec.SECURITY_PROFILE_NAMES == (
        "perf", "balanced", "hardened", "oblivious-sketch")
    assert DEFAULT_PROFILE is PROFILES["perf"]
    for name in SECURITY_PROFILE_NAMES:
        assert dataclasses.asdict(PROFILES[name]) == \
            dataclasses.asdict(jsec.PROFILES[name])
        for k in (1, 5, 16, 17, 100):
            assert PROFILES[name].result_width(k) == \
                jsec.PROFILES[name].result_width(k)
        assert PROFILES[name].tee_refine_cost(80, 32) == \
            jsec.PROFILES[name].tee_refine_cost(80, 32)
    p = get_profile("hardened")
    assert isinstance(p, SecurityProfile)
    assert get_profile(p) is p                      # idempotent
    with pytest.raises(ValueError, match="unknown security profile"):
        get_profile("bogus")
    assert sec.__all__ == jsec.__all__


def test_profile_tier_monotonicity_and_widths():
    perf, bal = get_profile("perf"), get_profile("balanced")
    hard, obl = get_profile("hardened"), get_profile("oblivious-sketch")
    assert not perf.pad_results and not perf.oblivious
    assert bal.pad_results and not bal.oblivious
    assert hard.pad_results and hard.oblivious
    assert obl.pad_results and obl.oblivious and obl.refine == "tee-sketch"
    assert perf.result_width(5) == 5 and bal.result_width(5) == 16
    assert bal.result_width(17) == 32 and hard.result_width(33) == 64


def test_hardened_hnsw_is_refused():
    """The per-query host walk has no oblivious variant."""
    with pytest.raises(ValueError, match="scan-oblivious"):
        Collection("t", "h", D, device="cpu", keyless=True,
                   backend="hnsw", security_profile="hardened")


# ---------------------------------------------------------------------------
# The acceptance bar: real ids bit-identical to perf under every profile.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["flush", "continuous"])
@pytest.mark.parametrize("kind,quant", [("ivf", None), ("ivf", "int8"),
                                        ("flat", "pq8"), ("graph", None)])
def test_cross_profile_id_parity(corpus, scheduler, kind, quant):
    _, _, Q, T, _ = corpus
    got = {}
    for profile in ("perf", "balanced", "hardened"):
        col = _collection(corpus, profile, kind, quant, scheduler)
        try:
            batch, stats = col.search_batch(Q, T, K, ratio_k=6.0)
            one = col.submit(Q[0], T[0], K, ratio_k=6.0).result(timeout=60)
        finally:
            col.close()
        got[profile] = (batch, one)
        if profile == "hardened" and kind != "flat":
            # the oblivious scans touch every resident row: the filter's
            # cost counters no longer depend on which rows were probed
            assert stats.filter_dist_evals >= Q.shape[0] * N
    for profile in ("balanced", "hardened"):
        np.testing.assert_array_equal(got[profile][0], got["perf"][0])
        np.testing.assert_array_equal(got[profile][1], got["perf"][1])
    np.testing.assert_array_equal(got["perf"][1], got["perf"][0][0])


@pytest.mark.parametrize("scheduler", ["flush", "continuous"])
def test_dummy_query_accounting(corpus, scheduler):
    """A lone request: perf pads by replication (no dummies); balanced
    pads the flush bucket (1 here: no dummies) but counts the continuous
    table's 7 free slots; hardened pads every flush to max_batch."""
    _, _, Q, T, _ = corpus
    for profile in ("perf", "balanced", "hardened"):
        want = 0 if profile == "perf" else \
            7 if (profile == "hardened" or scheduler == "continuous") else 0
        col = _collection(corpus, profile, "ivf", None, scheduler)
        try:
            ids, stats = col.submit(Q[0], T[0], K, ratio_k=6.0,
                                    want_stats=True).result(timeout=60)
            snap = col.stats()
        finally:
            col.close()
        assert ids.shape == (K,)
        assert stats.n_dummy_queries == want
        assert snap["n_dummy_queries"] == want
        assert snap["security_profile"] == profile


# ---------------------------------------------------------------------------
# Through the api: IndexSpec wire round trip + validation, result padding.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def owner_and_query():
    ds = synth.make_dataset("sift1m", n=N, n_queries=6, d=D, k_gt=10,
                            seed=0)
    spec = IndexSpec(tenant="t", name="base", d=D, seed=5,
                     sap_beta=dcpe.suggest_beta(ds.base, fraction=0.05))
    owner = DataOwnerClient(spec)
    C_sap, C_dce = owner.encrypt_vectors(ds.base, seed=11, device="cpu")
    return spec, C_sap, C_dce, owner.query_client().encrypt_queries(
        ds.queries)


def _one(query):
    """Slice a batch EncryptedQuery down to its first query."""
    return dataclasses.replace(query, C_sap=query.C_sap[:1],
                               T=query.T[:1])


def _spec(base, profile, name, *, quant=None, scheduler="flush",
          backend="ivf"):
    extra = dict(n_partitions=8, nprobe=3) if backend == "ivf" else {}
    return dataclasses.replace(base, name=name, backend=backend,
                               scheduler=scheduler, max_batch=8,
                               quantization=quant,
                               security_profile=profile, **extra)


def test_indexspec_security_profile_wire_roundtrip():
    spec = IndexSpec(tenant="t", name="c", d=D,
                     security_profile="hardened")
    assert IndexSpec.from_bytes(spec.to_bytes()) == spec
    assert spec.to_bytes() == japi.IndexSpec(
        tenant="t", name="c", d=D, security_profile="hardened").to_bytes()
    # additive wire versioning: payloads from before the field
    d = spec.to_dict()
    del d["security_profile"]
    assert IndexSpec.from_dict(d).security_profile == "perf"


def test_indexspec_rejects_bad_profiles():
    with pytest.raises(ValueError, match="security_profile"):
        IndexSpec(tenant="t", name="c", d=D, security_profile="bogus")
    with pytest.raises(ValueError, match="scan-oblivious"):
        IndexSpec(tenant="t", name="c", d=D, backend="hnsw",
                  security_profile="hardened")
    IndexSpec(tenant="t", name="c", d=D, backend="hnsw",
              security_profile="balanced")


@pytest.mark.parametrize("scheduler", ["flush", "continuous"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_service_cross_profile_id_parity(owner_and_query, scheduler, quant):
    spec0, C_sap, C_dce, query = owner_and_query
    params = SearchParams(k=K, ratio_k=6.0)
    got = {}
    for profile in ("perf", "balanced", "hardened"):
        spec = _spec(spec0, profile, f"par-{profile}", quant=quant,
                     scheduler=scheduler)
        with SecureAnnService(device="cpu") as svc:
            svc.create_collection(spec)
            svc.insert("t", spec.name, C_sap, C_dce)
            batch = svc.submit(SearchRequest(
                tenant="t", collection=spec.name, query=query,
                params=params, coalesce=False))
            one = svc.submit(SearchRequest(          # scheduler path
                tenant="t", collection=spec.name, query=_one(query),
                params=params))
        # padding profiles widen the id matrix to the pow2 bucket...
        width = get_profile(profile).result_width(params.k)
        assert batch.k == width and one.k == width
        got[profile] = (batch.ids_lists(), [one.ids_lists()[0]])
    for profile in ("balanced", "hardened"):
        for ref, ids in zip(got["perf"], got[profile]):
            # ...but the real ids are bit-identical to perf
            for a, b in zip(ref, ids):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scheduler", ["flush", "continuous"])
def test_dummy_and_padding_accounting(owner_and_query, scheduler):
    spec0, C_sap, C_dce, query = owner_and_query
    params = SearchParams(k=K, ratio_k=6.0)
    for profile in ("perf", "balanced", "hardened"):
        want_dummies = 0 if profile == "perf" else \
            7 if (profile == "hardened" or scheduler == "continuous") else 0
        spec = _spec(spec0, profile, f"acct-{profile}",
                     scheduler=scheduler)
        with SecureAnnService(device="cpu") as svc:
            svc.create_collection(spec)
            svc.insert("t", spec.name, C_sap, C_dce)
            res = svc.submit(SearchRequest(      # lone coalesced query
                tenant="t", collection=spec.name, query=_one(query),
                params=params))
            st = svc.stats("t", spec.name)
        assert res.stats.n_dummy_queries == want_dummies
        assert st["n_dummy_queries"] == want_dummies
        assert st["security_profile"] == profile
        if get_profile(profile).pad_results:
            # k=8 -> 16-column bucket: 8 pad cols x 8 bytes recorded
            assert st["padded_result_bytes"] == 64
        else:
            assert st["padded_result_bytes"] == 0


def test_padded_result_wire_roundtrip(owner_and_query):
    spec0, C_sap, C_dce, query = owner_and_query
    spec = _spec(spec0, "balanced", "wire-bal")
    with SecureAnnService(device="cpu") as svc:
        svc.create_collection(spec)
        svc.insert("t", spec.name, C_sap, C_dce)
        res = svc.submit(SearchRequest(
            tenant="t", collection=spec.name, query=query,
            params=SearchParams(k=K, ratio_k=6.0), coalesce=False))
    assert res.k == 16 and (res.ids[:, K:] == -1).all()
    rt = SearchResult.from_bytes(res.to_bytes())
    np.testing.assert_array_equal(rt.ids, res.ids)
    # the JAX package reads the padded frame alike
    np.testing.assert_array_equal(
        japi.SearchResult.from_bytes(res.to_bytes()).ids, res.ids)
    for a, b in zip(rt.ids_lists(), res.ids_lists()):
        np.testing.assert_array_equal(a, b)      # -1 padding stripped
        assert (a >= 0).all() and len(a) <= K
