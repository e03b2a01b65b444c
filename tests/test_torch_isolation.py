"""Guards of the PyTorch port: it stands alone, it defaults to the card,
and its kernel wrappers never cross between kernel and plain version.

This file imports neither JAX nor the JAX package, so its CUDA tests
also run where JAX is not installed:

    python -m pytest -m cuda tests/test_torch_isolation.py
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import (DataOwnerClient, IndexSpec, SearchParams,
                             SearchRequest, SecureAnnService)
from repro_torch.core import dce, dcpe, ppanns, secure_knn
from repro_torch.kernels import _build
from repro_torch.kernels.adc_topk import adc_topk
from repro_torch.kernels.adc_topk import ref as adc_ref
from repro_torch.kernels.dce_comp import dce_comp
from repro_torch.kernels.graph_expand import graph_expand
from repro_torch.kernels.l2_topk import l2_topk
from repro_torch.obs import profile_kernels
from repro_torch.sec import capture_server_view, evaluate_profile
from repro_torch.serving.runtime import (Collection, CollectionManager,
                                         DeltaAwareBackend,
                                         MutableEncryptedStore,
                                         jit_cache_size)
from repro_torch.serving.search_engine import SecureSearchEngine

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)",
                       re.MULTILINE)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have "
                    "no CPU mode")


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch, repro_torch.core, repro_torch.serving, "
            "repro_torch.obs, repro_torch.data.synth, repro_torch.kernels."
            "l2_topk, repro_torch.kernels.dce_comp, repro_torch.graph, "
            "repro_torch.kernels.graph_expand.ops, repro_torch.kernels."
            "adc_topk, repro_torch.core.adc, repro_torch.core.ivf, "
            "repro_torch.serving.runtime, repro_torch.sec, "
            "repro_torch.obs.metrics, repro_torch.obs.profiler, "
            "repro_torch.api.protocol, repro_torch.api.keystore, "
            "repro_torch.api.roles, repro_torch.sec.leakage, "
            "repro_torch.core.aspe, repro_torch.core.attacks\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None "
            "and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_source_imports_jax_or_the_jax_package(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.findall(text), path


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a CUDA device, device=None raises instead of carrying on
    on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    C_sap = np.zeros((4, 8), np.float32)
    C_dce = np.zeros((4, 4, dce.ciphertext_dim(8)), np.float32)
    owner = ppanns.DataOwner(d=8, sap_beta=1.0)
    client = DataOwnerClient(IndexSpec(tenant="t", name="c", d=8))
    X = np.ones((3, 8), np.float32)
    for call in (lambda: SecureSearchEngine(C_sap, C_dce),
                 lambda: SecureAnnService(),
                 lambda: SecureAnnService.load("no-such-dir"),
                 lambda: client.encrypt_vectors(X),
                 lambda: capture_server_view("perf", n=64, d=8, nq=2),
                 lambda: evaluate_profile("perf", n=64, d=8, nq=2),
                 lambda: Collection("t", "c", 8, sap_beta=1.0),
                 lambda: CollectionManager(),
                 lambda: CollectionManager(device="cpu").create_collection(
                     "t", "c", 8, sap_beta=1.0, device=None),
                 lambda: DeltaAwareBackend(MutableEncryptedStore(8, 32)),
                 lambda: owner.encrypt_vectors(X),
                 lambda: dce.encrypt_torch(X, owner.keys.dce_key),
                 lambda: dcpe.encrypt_torch(X, owner.keys.sap_key),
                 lambda: secure_knn.refine_tournament(
                     C_dce, np.arange(4), np.ones(C_dce.shape[-1]), 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cpu_tensors_never_reach_the_launch_path(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("CPU tensor reached the kernel launch path")
    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    before = _launch_counts()
    out = l2_topk.pairwise_sq_dists(torch.ones(2, 3), torch.ones(4, 3))
    torch.testing.assert_close(out, torch.zeros(2, 4))
    d, i = l2_topk.knn(torch.ones(2, 3), torch.ones(4, 3), 3)
    assert i.tolist() == [[0, 1, 2], [0, 1, 2]]
    Z = dce_comp.batched_z_matrix(torch.ones(2, 5, 4, 6), torch.ones(2, 6))
    assert Z.shape == (2, 5, 5)
    ids = dce_comp.refine_topk(torch.ones(7, 4, 6), torch.zeros(2, 5).long(),
                               torch.ones(2, 6), None, 3)
    assert ids.tolist() == [[0, 0, 0], [0, 0, 0]]
    beam_i, *_ = graph_expand.expand_layer0(*_graph_inputs("cpu", 2, 64, 4, 3),
                                            ef=4, ef_cap=32, max_hops=16)
    assert beam_i.shape == (2, 32)
    n0, up, ok, C, Qg, entry = _walk_inputs("cpu", 2, 64, 4, 2, 3, 3)
    beam_i, *_ = graph_expand.graph_walk(n0, up, ok, C, Qg, entry, 4,
                                         ef_cap=32, max_hops=16)
    assert beam_i.shape == (2, 32)
    adc_before = dict(adc_topk.launches)
    d, i = adc_topk.sq_adc_topk(*_sq_inputs("cpu", 2, 50, 9), 7)
    assert d.dtype == torch.int32 and i.shape == (2, 7)
    d, i = adc_topk.pq_adc_topk(*_pq_inputs("cpu", 2, 50, 3), 7)
    assert d.dtype == torch.float32 and i.dtype == torch.int64
    assert _launch_counts() == before
    assert adc_topk.launches == adc_before


def _runtime_corpus(n=300, nq=6, d=16, seed=0):
    """Numpy-encrypted rows, queries and an owner-built graph (the
    runtime's keyless inputs)."""
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, d)).astype(np.float32)
    owner = ppanns.DataOwner(d=d, sap_beta=dcpe.suggest_beta(P, 0.05),
                             seed=seed)
    db = owner.encrypt_database(P, build_index=False)
    user = ppanns.User(owner.share_keys())
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in
                               rng.standard_normal((nq, d)))))
    return db.C_sap, db.C_dce, Q, T


_RUNTIME_KINDS = [("flat", None), ("flat", "int8"), ("flat", "pq8"),
                  ("graph", None)]


def _runtime_run(device, kind, quant, C_sap, C_dce, Q, T, k=5):
    """A keyless collection through snapshot load, a delete, an insert
    burst (a live delta), searches, a compaction and a second burst.
    Returns (ids of the delta search, ids after compaction, deleted ids,
    K1 launches a batch while the delta was non-empty, builds+loads
    after warmup)."""
    kw = {"pq_m": 4} if quant == "pq8" else {}
    if kind == "graph":
        kw.update(hnsw_M=8, hnsw_ef_construction=32)
    col = Collection("t", f"{kind}-{quant}", C_sap.shape[1], device=device,
                     keyless=True, seed=1, backend=kind,
                     quantization=quant, compact_every=10_000, max_batch=4,
                     **kw)
    try:
        n0 = C_sap.shape[0] - 40
        if kind == "graph":
            col.insert_encrypted(C_sap[:n0], C_dce[:n0])
        else:
            col.load_snapshot(C_sap[:n0], C_dce[:n0])
        col.warmup(k)
        audit = jit_cache_size()
        first, _ = col.search_batch(Q, T, k)
        gone = np.unique(first[:, :2])
        col.delete(gone)
        col.insert_encrypted(C_sap[n0:n0 + 20], C_dce[n0:n0 + 20])
        before = l2_topk.launches["knn"]
        delta, _ = col.search_batch(Q, T, k)
        per_batch = l2_topk.launches["knn"] - before
        col.compact()
        col.insert_encrypted(C_sap[n0 + 20:], C_dce[n0 + 20:])
        via = np.stack([col.submit(q, t, k).result(timeout=60)
                        for q, t in zip(Q, T)])
        direct, _ = col.search_batch(Q, T, k)
        np.testing.assert_array_equal(via, direct)
        return delta, direct, gone, per_batch, jit_cache_size() - audit
    finally:
        col.close()


@pytest.mark.parametrize("kind,quant", _RUNTIME_KINDS)
def test_runtime_on_cpu_never_reaches_the_launch_path(monkeypatch, kind,
                                                      quant):
    def refuse(*a, **kw):
        raise AssertionError("CPU tensor reached the kernel launch path")
    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    before = _launch_counts()
    delta, after, gone, _, rebuilt = _runtime_run(
        "cpu", kind, quant, *_runtime_corpus())
    assert not np.isin(delta, gone).any() and not np.isin(after, gone).any()
    assert rebuilt == 0
    assert _launch_counts() == before


def _launch_counts() -> dict:
    """Every wrapper's launch count, by kernel (a copy)."""
    return {**{f"l2_topk.{k}": v for k, v in l2_topk.launches.items()},
            **{f"dce_comp.{k}": v for k, v in dce_comp.launches.items()},
            **{f"adc_topk.{k}": v for k, v in adc_topk.launches.items()},
            **{f"graph_expand.{k}": v
               for k, v in graph_expand.launches.items()}}


def test_mixed_devices_refused():
    meta = torch.empty(2, 3, device="meta")
    with pytest.raises(ValueError, match="mixed devices"):
        l2_topk.pairwise_sq_dists(torch.ones(2, 3), meta)
    with pytest.raises(ValueError, match="mixed devices"):
        l2_topk.knn(torch.ones(2, 3), meta, 2)
    with pytest.raises(ValueError, match="mixed devices"):
        dce_comp.refine_topk(torch.ones(7, 4, 6), torch.zeros(2, 5).long(),
                             torch.ones(2, 6), meta.bool(), 3)
    q8, c8, cn, ok = _sq_inputs("cpu", 2, 10, 3)
    with pytest.raises(ValueError, match="mixed devices"):
        adc_topk.sq_adc_topk(q8, c8, cn, ok.to("meta"), 3)
    lut, codes_t, ok = _pq_inputs("cpu", 2, 10, 3)
    with pytest.raises(ValueError, match="mixed devices"):
        adc_topk.pq_adc_topk(lut.to("meta"), codes_t, ok, 3)


def test_chip_smoke_alone_or_without_a_card_prints_no_result(tmp_path):
    """In a directory that holds only chip_smoke.py it cannot import the
    port; without a CUDA device it stops at once.  Either way: a non-zero
    exit and no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--n", "100"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _graph_inputs(device, nq, R, M0, d, seed=0, ep_missing=True):
    """A random layer-0 graph (some -1 slots, some rows with ok = 0) over
    integer-valued rows, so every fp32 distance is exact in any summation
    order; entry points are random rows (query 0 gets -1: an empty
    graph's entry)."""
    rng = np.random.default_rng(seed)
    C = rng.integers(-8, 9, size=(R, d)).astype(np.float32)
    Q = rng.integers(-8, 9, size=(nq, d)).astype(np.float32)
    neigh0 = rng.integers(0, R, size=(R, M0)).astype(np.int32)
    neigh0[rng.random((R, M0)) < 0.1] = -1
    ok = rng.random(R) > 0.02
    ep = rng.integers(0, R, size=nq).astype(np.int64)
    if ep_missing:
        ep[0] = -1
    ep_d = ((C[np.maximum(ep, 0)] - Q) ** 2).sum(-1).astype(np.float32)
    ep_d[ep < 0] = np.inf
    return [torch.as_tensor(a, device=device)
            for a in (neigh0, ok, C, Q, ep, ep_d)]


def _walk_inputs(device, nq, R, M0, M, LU, d, seed=0, empty_top=2,
                 entry=None):
    """`_graph_inputs`' layer 0 under LU upper layers: the top `empty_top`
    of them -1 rows only (empty padded layers), the others rows of M ids
    (some -1) on a shrinking set of nodes; the entry is an ok node of
    layer 0's upper neighbour set (or `entry`)."""
    neigh0, ok, C, Q, _, _ = _graph_inputs("cpu", nq, R, M0, d, seed=seed)
    rng = np.random.default_rng(seed + 1)
    up = np.full((LU, R, M), -1, np.int32)
    for li in range(LU - empty_top):
        nodes = rng.choice(R, size=max(2, R // (4 << li)), replace=False)
        rows = rng.choice(nodes, size=(len(nodes), M)).astype(np.int32)
        rows[rng.random(rows.shape) < 0.2] = -1
        up[li, nodes] = rows
    if entry is None:
        okn = ok.numpy()
        entry = int(np.flatnonzero(okn & (up[0, :, 0] >= 0))[0]) if LU \
            else int(np.flatnonzero(okn)[0])
    return [t.to(device) for t in (neigh0, torch.as_tensor(up), ok, C, Q)] \
        + [entry]


def _sq_inputs(device, nq, n, d, seed=0, valid=1.0, dup=0, far=False):
    """Random int8 codes with their norms; `dup` rows repeated further
    down (exact ties between distinct ids); a `valid` share of ok rows;
    `far`: codes of the opposite sign to the queries, so every surrogate
    is large (above 2^24 at d = 960)."""
    rng = np.random.default_rng(seed)
    lo, hi = (100, 128) if far else (-127, 128)
    q8 = rng.integers(lo, hi, size=(nq, d)).astype(np.int8)
    lo, hi = (-127, -99) if far else (-127, 128)
    c8 = rng.integers(lo, hi, size=(n, d)).astype(np.int8)
    if dup:
        c8[n - dup:] = c8[:dup]
    cn = (c8.astype(np.int32) ** 2).sum(1).astype(np.int32)
    ok = rng.random(n) < valid
    return [torch.as_tensor(a, device=device) for a in (q8, c8, cn, ok)]


def _pq_inputs(device, nq, n, m, seed=0, valid=1.0, dup=0):
    """Random tables (integer-valued in part, so equal sums occur) and
    codes; `dup` code columns repeated further down."""
    rng = np.random.default_rng(seed)
    lut = rng.random((nq, m, 256)).astype(np.float32) * 100
    lut[:, :, ::2] = np.round(lut[:, :, ::2])
    codes_t = rng.integers(0, 256, size=(m, n)).astype(np.uint8)
    if dup:
        codes_t[:, n - dup:] = codes_t[:, :dup]
    ok = (rng.random(n) < valid).astype(np.int32)
    return [torch.as_tensor(a, device=device) for a in (lut, codes_t, ok)]


# ------------------------------------------------------- on the card only

@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    _needs_card()

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(l2_topk, "plain_pairwise_sq_dists", refuse)
    monkeypatch.setattr(dce_comp, "plain_batched_z_matrix", refuse)
    monkeypatch.setattr(graph_expand, "plain_expand_layer0", refuse)
    monkeypatch.setattr(graph_expand, "plain_graph_walk", refuse)
    monkeypatch.setattr(graph_expand._ref, "beam_layer0", refuse)
    monkeypatch.setattr(graph_expand._traverse, "traverse", refuse)
    monkeypatch.setattr(graph_expand._traverse, "upper_entry", refuse)
    for name in ("plain_sq_adc_topk", "plain_pq_adc_topk"):
        monkeypatch.setattr(adc_topk, name, refuse)
    for name in ("sq_adc_topk", "pq_adc_topk", "sq_dists", "pq_dists"):
        monkeypatch.setattr(adc_ref, name, refuse)
    monkeypatch.setattr(l2_topk, "plain_knn", refuse)
    monkeypatch.setattr(dce_comp, "plain_refine_topk", refuse)
    before = _launch_counts()
    Q = torch.randn(5, 33, device="cuda")
    X = torch.randn(70, 33, device="cuda")
    l2_topk.pairwise_sq_dists(Q, X)
    l2_topk.knn(Q, X, 9)
    C = torch.randn(3, 9, 4, 40, device="cuda")
    T = torch.randn(3, 40, device="cuda")
    dce_comp.batched_z_matrix(C, T)
    dce_comp.refine_topk(C.reshape(27, 4, 40),
                         torch.arange(27, device="cuda").reshape(3, 9), T,
                         None, 4)
    graph_expand.expand_layer0(*_graph_inputs("cuda", 3, 64, 4, 8), ef=8,
                               ef_cap=32, max_hops=64)
    n0, up, ok, C, Qg, entry = _walk_inputs("cuda", 3, 64, 4, 2, 3, 8)
    graph_expand.graph_walk(n0, up, ok, C, Qg, entry, 8, ef_cap=32,
                            max_hops=64)
    adc_topk.sq_adc_topk(*_sq_inputs("cuda", 3, 300, 17), 20)
    adc_topk.pq_adc_topk(*_pq_inputs("cuda", 3, 300, 4), 20)
    torch.cuda.synchronize()
    assert _launch_counts() == {k: v + 1 for k, v in before.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("nq,n,d", [(1, 1, 2), (33, 70, 96), (5, 300, 960)])
def test_l2_kernel_matches_plain_on_the_card(nq, n, d):
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(nq + n + d)
    Q = torch.randn(nq, d, device="cuda", generator=g)
    X = torch.randn(n, d, device="cuda", generator=g)
    got = l2_topk.pairwise_sq_dists(Q, X)
    want = l2_topk.plain_pairwise_sq_dists(Q, X)
    scale = (Q * Q).sum(1)[:, None] + (X * X).sum(1)[None, :]
    assert ((got - want).abs() <= 1e-5 * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d", [(1, 5, 4), (3, 80, 128), (2, 33, 17),
                                   (1, 512, 128), (32, 160, 64)])
def test_z_kernel_matches_plain_on_the_card(B, n, d):
    _needs_card()
    key = dce.keygen(d, seed=d)
    rng = np.random.default_rng(d)
    C = torch.as_tensor(dce.encrypt(rng.standard_normal((B * n, d)), key,
                                    seed=1).reshape(B, n, 4, -1),
                        device="cuda")
    T = torch.as_tensor(dce.trapgen(rng.standard_normal((B, d)), key,
                                    seed=2), device="cuda")
    got = dce_comp.batched_z_matrix(C, T)
    want = dce_comp.plain_batched_z_matrix(C, T)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # each set alone (z_matrix, its j-tiles split over more blocks where
    # the rows leave SMs idle) is bit-equal to the batched call: every
    # element is the same two fp32 chains in ascending depth
    for b in range(B):
        assert torch.equal(dce_comp.z_matrix(C[b].contiguous(),
                                             T[b].contiguous()), got[b])
    # and on small integers (every sum exact), bit-equal to the plain one
    g = torch.Generator(device="cuda").manual_seed(n)
    Ci = torch.randint(-8, 9, C.shape, generator=g, device="cuda").float()
    Ti = torch.randint(-3, 4, T.shape, generator=g, device="cuda").float()
    assert torch.equal(dce_comp.batched_z_matrix(Ci, Ti),
                       dce_comp.plain_batched_z_matrix(Ci, Ti))


@pytest.mark.cuda
@pytest.mark.parametrize("nq,R,M0,d,ef,ef_cap", [
    (5, 300, 7, 13, 20, 32), (32, 4096, 16, 128, 96, 128),
    (3, 1000, 32, 960, 64, 64)])
def test_graph_expand_kernel_matches_plain_on_the_card(nq, R, M0, d, ef,
                                                       ef_cap):
    """Integer-valued rows: every distance is exact in both summation
    orders, so the kernel must equal its plain version exactly (beam,
    visited trace, hops, edges), ties and all."""
    _needs_card()
    args = _graph_inputs("cuda", nq, R, M0, d, seed=R)
    kw = dict(ef=ef, ef_cap=ef_cap, max_hops=4 * ef_cap)
    got = graph_expand.expand_layer0(*args, **kw)
    want = graph_expand.plain_expand_layer0(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[3].max()) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("nq,R,M0,M,LU,d,ef,ef_cap,entry", [
    (5, 300, 7, 3, 4, 13, 20, 32, None),     # ragged M0 and d
    (32, 4096, 16, 8, 8, 128, 96, 128, None),  # the graph path's widths
    (3, 1000, 32, 16, 4, 960, 64, 64, None),   # GIST width
    (4, 3000, 16, 8, 4, 64, 1600, 2048, None),  # k' 1600: ef_cap 2048
    (3, 2000, 33, 5, 3, 16, 40, 64, None),   # M0 > 32: two row groups
    (3, 500, 8, 4, 0, 16, 30, 32, None),     # no upper layer
    (2, 300, 8, 4, 4, 16, 30, 32, -1)])      # an empty graph
def test_graph_walk_kernel_matches_plain_on_the_card(nq, R, M0, M, LU, d,
                                                     ef, ef_cap, entry):
    """The fused walk (descent through 2 empty padded layers and the
    others, then layer 0) on integer-valued rows: ids, distances, visited,
    hops and edges equal the torch walk's exactly."""
    _needs_card()
    n0, up, ok, C, Q, e = _walk_inputs("cuda", nq, R, M0, M, LU, d, seed=R,
                                       empty_top=min(2, LU), entry=entry)
    kw = dict(ef_cap=ef_cap, max_hops=4 * ef_cap)
    got = graph_expand.graph_walk(n0, up, ok, C, Q, e, ef, **kw)
    want = graph_expand.plain_graph_walk(n0, up, ok, C, Q, e, ef, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if e >= 0:
        assert int(got[3].min()) > LU


@pytest.mark.cuda
@pytest.mark.parametrize("nq,n,d,kp,valid,dup", [
    (1, 1, 4, 1, 1.0, 0),            # one row
    (5, 1000, 17, 30, 0.9, 0),       # ragged d, an ok mask
    (3, 100, 16, 30, 0.12, 0),       # ~12 valid rows: empty slots
    (33, 5000, 128, 1024, 1.0, 0),   # kp 1024, ragged query group
    (32, 70001, 128, 160, 0.99, 3000),   # ties, ragged n, many chunks
    (4, 3000, 960, 50, 1.0, 500),    # GIST width: int32 surrogates > 2^24
    (1, 5000, 128, 160, 1.0, 0),     # one query in a group of 32
    (33, 20000, 960, 300, 0.95, 200),    # d 960, 16 queries a block
    (2, 3000, 17, 1024, 1.0, 100),   # kp 1024 over byte-loaded rows
    (3, 40000, 1, 64, 1.0, 0),       # d 1: one byte of a 64-byte slice
    (3, 3000, 16, 1025, 1.0, 200),   # MAX_KP + 1: passes of 513 and 512
    (17, 2600, 128, 1600, 0.9, 100),  # kp 1600: two passes of 800
    (2, 3000, 16, 1600, 0.3, 0)])    # ~900 valid: the second pass runs out
def test_sq_adc_kernel_matches_plain_on_the_card(nq, n, d, kp, valid, dup):
    """Integer surrogates: ids and int32 distances exactly equal."""
    _needs_card()
    args = _sq_inputs("cuda", nq, n, d, seed=n + d, valid=valid, dup=dup,
                      far=d == 960)
    got = adc_topk.sq_adc_topk(*args, kp)
    want = adc_topk.plain_sq_adc_topk(*args, kp)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    ids = got[1]
    assert ((ids >= 0).sum(1) == min(kp, int(args[3].sum()))).all()
    real = ids[0][ids[0] >= 0]
    assert real.unique().numel() == real.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("nq,n,m,kp,valid,dup", [
    (1, 1, 1, 1, 1.0, 0),
    (5, 1000, 8, 30, 0.9, 0),
    (3, 100, 16, 30, 0.12, 0),
    (33, 5000, 16, 1024, 1.0, 0),
    (32, 70001, 16, 320, 0.99, 3000),
    (4, 3000, 3, 50, 1.0, 0),        # few subspaces: many equal sums
    (1, 5000, 16, 320, 1.0, 0),      # one query in a group of 8
    (5, 3000, 32, 100, 1.0, 0),      # m 32: 4 queries a block
    (3, 2000, 64, 1024, 0.9, 100),   # m 64, kp 1024: 2 queries a block
    (2, 1001, 200, 20, 1.0, 0),      # m 200: 1 query a block, n % 4 != 0
    (9, 2500, 16, 1600, 0.95, 200)])  # kp 1600: two passes of 800
def test_pq_adc_kernel_matches_plain_on_the_card(nq, n, m, kp, valid, dup):
    """Sums in ascending subspace order on both sides: ids and float32
    distances bit-equal."""
    _needs_card()
    args = _pq_inputs("cuda", nq, n, m, seed=n + m, valid=valid, dup=dup)
    got = adc_topk.pq_adc_topk(*args, kp)
    want = adc_topk.plain_pq_adc_topk(*args, kp)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    ids = got[1]
    assert ((ids >= 0).sum(1) == min(kp, int(args[2].sum()))).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nq,n,d,k,dup", [
    (1, 1, 4, 1, 0),                 # one row
    (5, 1000, 33, 30, 0),            # ragged d: 4-byte copies
    (33, 5000, 128, 80, 500),        # ragged query group, ties
    (32, 70001, 128, 80, 3000),      # many chunks, ragged n, ties
    (3, 3000, 960, 50, 0),           # GIST width
    (9, 4000, 64, 1024, 0),          # k 1024: 8 queries a block
    (40, 300, 16, 300, 100),         # k = n: every row selected
    (3, 3000, 16, 1025, 300),        # MAX_KP + 1: passes of 513 and 512
    (9, 2500, 64, 1600, 200)])       # k' 1600: two passes of 800
def test_knn_kernel_matches_plain_on_the_card(nq, n, d, k, dup):
    """Integer-valued rows and queries: every distance is exact in any
    summation order, so the fused scan must equal the plain chunked merge
    exactly, ties (duplicated rows) to the lowest id included."""
    _needs_card()
    rng = np.random.default_rng(n + d)
    X = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    if dup:
        X[n - dup:] = X[:dup]
    Q = rng.integers(-8, 9, size=(nq, d)).astype(np.float32)
    Q, X = torch.as_tensor(Q, device="cuda"), torch.as_tensor(X, device="cuda")
    got = l2_topk.knn(Q, X, k)
    want = l2_topk.plain_knn(Q, X, k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _refine_inputs(device, B, n, d, seed, dup=0, invalid=0.0):
    """Real DCE ciphertexts of B * n rows read through a shuffled cand;
    `dup` slots of each set repeat another slot's id (tied wins); an
    `invalid` share of slots masked, half of them with id -1; query 0
    with 3 valid slots."""
    rng = np.random.default_rng(seed)
    key = dce.keygen(d, seed=seed)
    C = dce.encrypt(rng.standard_normal((B * n, d)), key, seed=seed + 1)
    T = dce.trapgen(rng.standard_normal((B, d)), key, seed=seed + 2)
    cand = np.arange(B * n).reshape(B, n)
    cand = rng.permuted(cand, axis=1)
    if dup:
        cand[:, n - dup:] = cand[:, :dup]
    valid = rng.random((B, n)) >= invalid
    if invalid:
        valid[0] = False
        valid[0, :3] = True
        cand[~valid & (rng.random((B, n)) < 0.5)] = -1
    return [torch.as_tensor(a, device=device)
            for a in (C.astype(np.float32), cand, T.astype(np.float32),
                      valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d,k,dup,invalid", [
    (1, 1, 4, 1, 0, 0.0),
    (3, 9, 17, 4, 0, 0.0),           # ragged D
    (32, 80, 128, 10, 0, 0.1),       # the flat and graph paths' shape
    (32, 160, 128, 10, 20, 0.1),     # ADC int8, tied wins
    (32, 320, 128, 10, 0, 0.0),      # ADC pq8
    (4, 70, 64, 60, 10, 0.3),        # k above the valid count of query 0
    (2, 1500, 32, 1500, 0, 0.0)])    # k = n, several rank tiles
def test_refine_kernel_matches_plain_on_the_card(B, n, d, k, dup, invalid):
    """The fused refine's win counts equal those of the Z entry (the same
    main loop) exactly, its ids are the stable ranking of those wins, and
    both equal the plain version wherever no pair of valid slots is a
    near-tie (|Z| <= 1e-5 max|Z|, where sums in another order may flip)."""
    _needs_card()
    from repro_torch.kernels.dce_comp.ref import batched_wins
    C_dce, cand, T, valid = _refine_inputs("cuda", B, n, d, seed=n + d,
                                           dup=dup, invalid=invalid)
    v = valid if invalid else None
    ids, wins = dce_comp.refine_topk(C_dce, cand, T, v, k, return_wins=True)
    ids_p, wins_p = dce_comp.plain_refine_topk(C_dce, cand, T, v, k,
                                               return_wins=True)
    Cc = C_dce[cand]
    assert torch.equal(wins, batched_wins(dce_comp.batched_z_matrix(Cc, T),
                                          v))
    local = torch.sort(-wins, dim=1, stable=True).indices[:, :k]
    want = torch.where(torch.gather(valid, 1, local),
                       torch.gather(cand, 1, local), -1)
    assert torch.equal(ids, want)
    Z = dce_comp.plain_batched_z_matrix(Cc, T)
    pairs = valid[:, :, None] & valid[:, None, :] & ~torch.eye(
        n, dtype=torch.bool, device="cuda")[None]
    unsure = (pairs & (Z.abs() <= 1e-5 * Z.abs().max())).any(-1)
    assert torch.equal(wins[~unsure], wins_p[~unsure])
    sure = ~unsure.any(-1)
    assert torch.equal(ids[sure], ids_p[sure])


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    _needs_card()
    Q = torch.randn(4, 8, device="cuda")
    with pytest.raises(TypeError):
        l2_topk.pairwise_sq_dists(Q.double(), Q.double())
    with pytest.raises(ValueError):
        l2_topk.pairwise_sq_dists(Q, torch.randn(8, 4, device="cuda").T)
    X = torch.randn(2000, 8, device="cuda")
    with pytest.raises(TypeError):
        l2_topk.knn(Q.double(), X.double(), 5)
    with pytest.raises(ValueError, match="mixed devices"):
        l2_topk.knn(Q, X.cpu(), 5)
    C_dce, cand, T, valid = _refine_inputs("cuda", 2, 9, 8, seed=1)
    with pytest.raises(TypeError):
        dce_comp.refine_topk(C_dce, cand.int(), T, valid, 3)
    with pytest.raises(TypeError):
        dce_comp.refine_topk(C_dce.double(), cand, T, valid, 3)
    with pytest.raises(ValueError):
        dce_comp.refine_topk(C_dce, cand, T[:1], valid, 3)
    with pytest.raises(ValueError, match="mixed devices"):
        dce_comp.refine_topk(C_dce, cand, T, valid.cpu(), 3)
    with pytest.raises(ValueError):
        dce_comp.batched_z_matrix(torch.randn(2, 3, 4, 8, device="cuda"),
                                  torch.randn(3, 8, device="cuda"))
    n0, ok, C, Qg, ep, ep_d = _graph_inputs("cuda", 2, 64, 4, 8)
    with pytest.raises(TypeError):
        graph_expand.expand_layer0(n0.long(), ok, C, Qg, ep, ep_d, ef=4,
                                   ef_cap=32, max_hops=8)
    with pytest.raises(ValueError):
        graph_expand.expand_layer0(n0, ok, C, Qg, ep, ep_d, ef=33,
                                   ef_cap=32, max_hops=8)
    n0, up, ok, C, Qg, entry = _walk_inputs("cuda", 2, 64, 4, 2, 3, 8)
    with pytest.raises(ValueError):
        graph_expand.graph_walk(n0, up.long(), ok, C, Qg, entry, 4,
                                ef_cap=32, max_hops=8)
    with pytest.raises(TypeError):
        graph_expand.graph_walk(n0, up, ok, C.double(), Qg, entry, 4,
                                ef_cap=32, max_hops=8)
    with pytest.raises(ValueError, match="mixed devices"):
        graph_expand.graph_walk(n0, up.cpu(), ok, C, Qg, entry, 4,
                                ef_cap=32, max_hops=8)
    q8, c8, cn, ok = _sq_inputs("cuda", 2, 2000, 16)
    with pytest.raises(TypeError):
        adc_topk.sq_adc_topk(q8.int(), c8, cn, ok, 5)
    lut, codes_t, ok = _pq_inputs("cuda", 2, 2000, 256)
    with pytest.raises(ValueError, match="shared memory"):
        adc_topk.pq_adc_topk(lut, codes_t, ok, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,quant", _RUNTIME_KINDS)
def test_runtime_collections_on_the_card_equal_the_host(kind, quant):
    """The runtime on the card through a mutation sequence: its ids equal
    the host's plain versions' (>= 99% of slots: the fp32 sums of the
    filter and the refine are taken in another order), no deleted id
    comes back, the flat filter launches K1 twice a batch while the delta
    is non-empty, and nothing is built or loaded after warmup."""
    _needs_card()
    corpus = _runtime_corpus(n=1000, nq=32, d=32)
    card = _runtime_run(None, kind, quant, *corpus)
    host = _runtime_run("cpu", kind, quant, *corpus)
    for got, want in zip(card[:2], host[:2]):
        assert (got == want).mean() >= 0.99
    gone = card[2]
    assert not np.isin(card[0], gone).any()
    assert not np.isin(card[1], gone).any()
    assert card[3] == (2 if (kind, quant) == ("flat", None) else 0)
    assert card[4] == 0


@pytest.mark.cuda
def test_refine_array_written_in_place_on_the_card():
    """Inside a capacity bucket an insert burst is copied into the refine
    array's device tensor already held, bit-equal to a full upload."""
    _needs_card()
    C_sap, C_dce, Q, T = _runtime_corpus(n=300, nq=4, d=16)
    col = Collection("t", "c", 16, keyless=True, seed=1,
                     compact_every=10_000)
    try:
        col.load_snapshot(C_sap[:200], C_dce[:200])
        col.search_batch(Q, T, 5)
        ptr = col._backend._C_dce_dev.data_ptr()
        col.insert_encrypted(C_sap[200:], C_dce[200:])
        col.search_batch(Q, T, 5)
        dev = col._backend._C_dce_dev
        assert dev.data_ptr() == ptr and dev.is_cuda
        assert torch.equal(dev.cpu(), torch.from_numpy(
            col.store.dce_padded_view))
    finally:
        col.close()


@pytest.mark.cuda
def test_profiler_times_card_calls_with_cuda_events():
    _needs_card()
    Q = torch.randn(8, 32, device="cuda")
    X = torch.randn(5000, 32, device="cuda")
    from repro_torch.kernels.l2_topk import ops as l2_ops
    with profile_kernels() as prof:
        l2_ops.knn(Q, X, 10)
        l2_ops.knn(Q, X, 10)
    s = prof.summary()["l2_topk.knn"]
    assert s["calls"] == 2 and s["total_s"] > 0
    assert s["total_bytes"] == 2 * (Q.nbytes + X.nbytes)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,quant", [("flat", None), ("flat", "int8"),
                                        ("graph", None)])
def test_api_service_on_the_card_saves_what_the_host_loads(tmp_path, kind,
                                                           quant):
    """The api on the card: a keyless collection serves batch and
    coalesced requests through the hand kernels (one filter launch and
    one refine launch a batch), and the `.ppcol` it saves loads in a host
    service (plain versions) that answers with the same ids (>= 99% of
    slots: fp32 sums in another order) and equal file bytes on a second
    save."""
    _needs_card()
    C_sap, C_dce, Q, T = _runtime_corpus(n=1000, nq=32, d=32)
    graph = None
    if kind == "graph":
        from repro_torch.core.hnsw import HNSW
        graph = HNSW(32, M=8, ef_construction=32, seed=6).build(
            C_sap).to_arrays()
    from repro_torch.api import EncryptedCorpus, EncryptedQuery
    spec = IndexSpec(tenant="t", name=kind, d=32, backend=kind,
                     quantization=quant, seed=2, hnsw_M=8,
                     hnsw_ef_construction=32)
    query = EncryptedQuery(C_sap=Q, T=T)
    req = SearchRequest(tenant="t", collection=kind, query=query,
                        params=SearchParams(k=5), coalesce=False)
    kern = {("flat", None): l2_topk.launches, ("graph", None):
            graph_expand.launches}.get((kind, quant), adc_topk.launches)
    with SecureAnnService() as svc:
        svc.create_collection(spec, EncryptedCorpus(C_sap=C_sap, C_dce=C_dce,
                                                    index=graph))
        svc.warmup("t", kind, k=5)
        before = (sum(kern.values()), dce_comp.launches["refine_topk"])
        card = svc.submit(req).ids
        assert (sum(kern.values()) - before[0],
                dce_comp.launches["refine_topk"] - before[1]) == (1, 1)
        one = svc.submit(SearchRequest(
            tenant="t", collection=kind, params=SearchParams(k=5),
            query=EncryptedQuery(C_sap=Q[:1], T=T[:1]))).ids
        np.testing.assert_array_equal(one[0], card[0])
        (path,) = svc.save(tmp_path / "card")
    with SecureAnnService.load(tmp_path / "card", device="cpu") as svc:
        host = svc.submit(req).ids
        (again,) = svc.save(tmp_path / "host")
    assert (card == host).mean() >= 0.99
    assert again.read_bytes() == path.read_bytes()
