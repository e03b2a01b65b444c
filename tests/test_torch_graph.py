"""The port's graph filter against the JAX package's, on the CPU.

Setup of tests/test_graph.py (deep1m, n = 800, d = 32, M = 12,
ef_construction = 100, seed 21): the JAX package builds the system, and
the port gets the same ciphertexts and the graph through `to_arrays()`.
The port runs on CPU tensors, i.e. its plain PyTorch versions (the
graph_expand wrapper runs `ref.beam_layer0`); the JAX side
runs its XLA walk (`use_kernel=False`; its Pallas kernel cannot run on
this host, tests/test_graph.py::test_pallas_kernel_interpret_matches_xla).

Tolerances: ids, visited traces, hops, edges and SearchStats counts are
exactly equal; walk distances within rtol 1e-6 (fp32 sums of torch and
XLA, taken in another order).
"""

import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ppanns as jppanns
from repro.core.hnsw import HNSW as JHNSW
from repro.data import synth
from repro.graph import CSRGraph as JCSRGraph
from repro.graph import GraphFilter as JGraphFilter
from repro.graph import traverse as jtraverse
from repro.serving.search_engine import HNSWGraphFilter as JHNSWGraphFilter
from repro.serving.search_engine import SecureSearchEngine as JEngine
from repro_torch.core import ppanns
from repro_torch.core.hnsw import HNSW
from repro_torch.graph import CSRGraph, GraphFilter, beam_plan
from repro_torch.graph import traverse
from repro_torch.kernels.graph_expand import graph_expand
from repro_torch.kernels.graph_expand import ops as graph_ops
from repro_torch.serving.search_engine import (HNSWGraphFilter,
                                               SecureSearchEngine)

K = 10
CPU = "cpu"
COUNTS = ("filter_dist_evals", "n_hops", "n_edges_scanned",
          "filter_bytes_scanned", "refine_comparisons", "backend",
          "bytes_up", "bytes_down", "n_queries")


def _arrays_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), k


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*a, **kw)


@pytest.fixture(scope="module")
def setup():
    ds = synth.make_dataset("deep1m", n=800, n_queries=8, k_gt=30, seed=21,
                            d=32)
    _, juser, jserver = _quiet(jppanns.build_system, ds.base,
                               beta_fraction=0.03, M=12,
                               ef_construction=100, seed=21)
    qs, ts = zip(*(juser.encrypt_query(q) for q in ds.queries))
    index = HNSW.from_arrays(jserver.db.index.to_arrays())
    return ds, jserver, index, np.stack(qs), np.stack(ts)


# ---------------------------------------------------------------------------
# Build parity: the same seed and C_SAP give the same graph and CSR rows.
# ---------------------------------------------------------------------------

def test_hnsw_build_bit_identical():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((300, 24)).astype(np.float32)
    t = HNSW(24, M=8, ef_construction=40, seed=13).build(X)
    j = JHNSW(24, M=8, ef_construction=40, seed=13).build(X)
    _arrays_equal(t.to_arrays(), j.to_arrays())
    assert t.n_dist_evals == j.n_dist_evals
    # incremental insert and delete-with-repair stay in step too
    x = rng.standard_normal(24).astype(np.float32)
    assert t.insert(x) == j.insert(x)
    assert t.delete(7) == j.delete(7)
    _arrays_equal(t.to_arrays(), j.to_arrays())


def test_csr_to_arrays_bit_identical_with_deletes(setup):
    _, jserver, _, _, _ = setup
    th = HNSW.from_arrays(jserver.db.index.to_arrays())
    jh = JHNSW.from_arrays(jserver.db.index.to_arrays())
    for node in (5, 17, int(th.entry)):
        assert th.delete(node) == jh.delete(node)
    g, jg = CSRGraph.from_hnsw(th), JCSRGraph.from_hnsw(jh)
    _arrays_equal(g.to_arrays(), jg.to_arrays())
    _arrays_equal(g.to_arrays(), jh.to_arrays())
    for name in ("neigh0", "neigh_up", "levels", "X"):
        np.testing.assert_array_equal(getattr(g, name), getattr(jg, name))
    assert (g.R, g.LU, g.entry, g.max_level) == \
        (jg.R, jg.LU, jg.entry, jg.max_level)
    # arrays -> port HNSW -> arrays is the identity too
    _arrays_equal(CSRGraph.from_arrays(g.to_arrays()).to_arrays(),
                  jh.to_arrays())


def test_csr_incremental_refresh_matches_full_rebuild():
    rng = np.random.default_rng(4)
    h = HNSW(16, M=8, ef_construction=60, seed=4)
    h.build(rng.standard_normal((150, 16)).astype(np.float32))
    g = CSRGraph.from_hnsw(h, R=256)
    assert g.fits(h)
    node = h.insert(rng.standard_normal(16).astype(np.float32))
    dirty = {node}
    for lev in range(h.levels[node] + 1):
        dirty.update(np.asarray(h.links[lev][node]).tolist())
    dirty.add(30)
    dirty.update(h.delete(30))
    g.refresh_rows(h, sorted(dirty))
    g.refresh_meta(h)
    fresh = CSRGraph.from_hnsw(h, R=g.R, LU=g.LU)
    for name in ("neigh0", "neigh_up", "levels", "X"):
        np.testing.assert_array_equal(getattr(g, name), getattr(fresh, name))
    assert g.entry == fresh.entry and g.n == fresh.n
    _arrays_equal(g.to_arrays(), h.to_arrays())


# ---------------------------------------------------------------------------
# Walk parity against repro.graph.traverse.traverse.
# ---------------------------------------------------------------------------

def _walk_inputs(index, Q):
    g = CSRGraph.from_hnsw(index)
    X = np.where(np.isfinite(g.X), g.X, 0.0).astype(np.float32)
    return g, (g.neigh0, g.neigh_up, g.levels >= 0, X,
               np.asarray(Q, np.float32))


def _jax_walk(arrs, entry, ef, **kw):
    n0, nu, ok, X, Q = arrs
    out = jtraverse.graph_topk(
        jnp.asarray(n0), jnp.asarray(nu), jnp.asarray(ok), (jnp.asarray(X),),
        jnp.asarray(Q), jnp.int32(entry), jnp.int32(ef), **kw)
    return [np.asarray(o) for o in out]


def _torch_walk(fn, arrs, entry, ef, **kw):
    n0, nu, ok, X, Q = (torch.from_numpy(np.ascontiguousarray(a))
                        for a in arrs)
    out = fn(n0, nu, ok, (X,), Q, entry, ef, **kw)
    return [o.numpy() for o in out]


def _assert_walks_equal(got, want):
    cand, cand_d, vis, hops, edges = got
    w_cand, w_cand_d, w_vis, w_hops, w_edges = want
    assert cand.dtype == np.int32 and vis.dtype == np.bool_
    # an id may differ only where the two fp32 sums put two candidates
    # within 1e-5 of each other; every other slot compares exactly
    near_tie = np.abs(cand_d - w_cand_d) <= 1e-5 * np.abs(w_cand_d)
    bad = (cand != w_cand) & ~near_tie
    assert not bad.any(), "\n".join(
        f"q{q} slot {s}: port {cand[q, s]} ({cand_d[q, s]!r}) vs jax "
        f"{w_cand[q, s]} ({w_cand_d[q, s]!r})" for q, s in np.argwhere(bad))
    np.testing.assert_allclose(cand_d, w_cand_d, rtol=1e-6)
    np.testing.assert_array_equal(vis, w_vis)
    np.testing.assert_array_equal(hops, w_hops)
    np.testing.assert_array_equal(edges, w_edges)


@pytest.mark.parametrize("oblivious", [False, True])
@pytest.mark.parametrize("kp,ef", [(32, 64), (24, 40)])
def test_walk_matches_jax(setup, oblivious, kp, ef):
    """kp 24 / ef 40 runs with ef < ef_cap = 64 (effective-ef
    truncation); the oblivious variant runs the fixed trip counts."""
    _, _, index, Q, _ = setup
    g, arrs = _walk_inputs(index, Q)
    ef_eff, ef_cap, max_hops = beam_plan(kp, ef)
    assert (ef_eff < ef_cap) == (ef == 40)
    kw = dict(kp=kp, ef_cap=ef_cap, max_hops=max_hops, quant="f32",
              oblivious=oblivious)
    want = _jax_walk(arrs, g.entry, ef_eff, **kw)
    _assert_walks_equal(_torch_walk(traverse.traverse, arrs, g.entry,
                                    ef_eff, **kw), want)
    # the serving entry point: upper descent + the graph_expand wrapper
    # (plain version on CPU tensors) for the perf variant
    _assert_walks_equal(_torch_walk(graph_ops.graph_topk, arrs, g.entry,
                                    ef_eff, **kw), want)


def test_walk_on_an_empty_graph_matches_jax():
    g = CSRGraph.from_hnsw(HNSW(8, M=4, ef_construction=10))
    assert g.entry == -1
    Q = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    arrs = (g.neigh0, g.neigh_up, g.levels >= 0, g.X, Q)
    for oblivious in (False, True):
        kw = dict(kp=4, ef_cap=32, max_hops=128, quant="f32",
                  oblivious=oblivious)
        want = _jax_walk(arrs, -1, 8, **kw)
        got = _torch_walk(graph_ops.graph_topk, arrs, -1, 8, **kw)
        _assert_walks_equal(got, want)
        assert (got[0] == -1).all() and np.isinf(got[1]).all()


def test_adc_scoring_names_its_slice(setup):
    """The ADC edge scoring is ported: the quantized filters carry the
    reference's names, and what the reference refuses is refused with
    its ValueError."""
    _, _, index, _, _ = setup
    for q in ("int8", "pq8"):
        assert GraphFilter(index, quantization=q).name == \
            JGraphFilter(index, quantization=q).name == f"adc-graph-{q}"
    with pytest.raises(ValueError, match="None|int8|pq8"):
        GraphFilter(index, quantization="int4")
    q = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="edge-scoring"):
        traverse._score("int4", (torch.zeros(2, 4),), q,
                        torch.zeros(1, 1, dtype=torch.long))


# ---------------------------------------------------------------------------
# The kernel's rules, emulated per query on the CPU.
# ---------------------------------------------------------------------------

def _emulate_kernel(neigh0, neigh_up, ok, D, entry, ef, ef_cap, max_hops, *,
                    pool=True, svis=True, ep=None, ep_d=None):
    """The CUDA kernel's per-query program (csrc/graph_expand.cu) in numpy.

    graph_walk (ep None): the start at `entry`, the greedy descent of the
    upper layers (first minimum, strict improvement, GREEDY_BOUND steps,
    hops and valid edges counted, no visited bit), then layer 0;
    expand_layer0: layer 0 from ep / ep_d.  Layer 0 keeps a beam of ef
    slots: the first unexpanded slot (from the lowest slot that can hold
    one) is selected; the break rule against slot ef-1; the selected
    entry's neighbour row from its pool row (`pool`: the adjacency copied
    when it was scored, into the staging row it held) or from neigh0;
    visited bits all read before any is set, from the on-chip bitmap
    before the copies (`svis`) or with them (the output words); the
    merge by ranks: fresh neighbour m to slot lb_m + rank_m (lb_m by a
    binary search of the beam), beam entry s to s + #{fresh m : lb_m <=
    s}; the pool rows of the entries pushed out and of the neighbours
    not kept staged again.  D (nq, R) holds the exact edge distances."""
    nq, R = D.shape
    M0 = neigh0.shape[1]
    inf = np.float32(np.inf)
    out_i = np.full((nq, ef_cap), -1, np.int32)
    out_d = np.full((nq, ef_cap), inf, np.float32)
    words = np.zeros((nq, (R + 31) // 32), np.uint32)
    hops = np.zeros(nq, np.int32)
    edges = np.zeros(nq, np.int32)
    for q in range(nq):
        vis = words[q]

        def seen(ids):
            s = np.maximum(ids, 0)
            return ((vis[s >> 5] >> (s & 31).astype(np.uint32)) & 1) == 1

        def mark(i):
            vis[i >> 5] |= np.uint32(1 << (int(i) & 31))

        h = e = 0
        if ep is not None:
            cur, cur_d = int(ep[q]), np.float32(ep_d[q])
        else:
            cur = entry
            cur_d = D[q, entry] if entry >= 0 and ok[entry] else inf
            if np.isinf(cur_d):
                cur = -1
            for li in reversed(range(neigh_up.shape[0])):
                for _ in range(traverse.GREEDY_BOUND if cur >= 0 else 0):
                    ids = neigh_up[li, cur]
                    valid = (ids >= 0) & ok[np.maximum(ids, 0)]
                    d = np.where(valid, D[q, np.maximum(ids, 0)], inf)
                    m = int(np.argmin(d))                 # first minimum
                    h += 1
                    e += int(valid.sum())
                    if not d[m] < cur_d:
                        break
                    cur, cur_d = int(ids[m]), d[m]
        if cur >= 0:
            bd = np.full(ef, inf, np.float32)
            bi = np.full(ef, -1, np.int32)
            bx = np.ones(ef, bool)
            bd[0], bi[0], bx[0] = cur_d, cur, False
            hd = np.arange(ef)                   # pool rows of the slots
            stage = np.arange(ef, ef + M0)       # and the staging rows
            rows = {0: neigh0[cur].copy()}
            mark(cur)
            start = 0
            for _ in range(max_hops):
                unexp = [s for s in range(start, ef) if not bx[s]]
                if not unexp or np.isinf(bd[unexp[0]]) \
                        or bd[unexp[0]] > bd[ef - 1]:
                    break
                j = unexp[0]
                assert (rows[hd[j]] == neigh0[bi[j]]).all()
                ids = rows[hd[j]] if pool else neigh0[bi[j]]
                cand = ids >= 0
                if svis:
                    cand &= ~seen(ids)
                for m in np.flatnonzero(cand):   # copies with the rows
                    rows[stage[m]] = neigh0[ids[m]].copy()
                fresh = cand & ok[np.maximum(ids, 0)]
                if not svis:
                    fresh &= ~seen(ids)
                nd = D[q, np.maximum(ids, 0)]
                nf = int(fresh.sum())
                lb, slot = {}, {}
                for m in np.flatnonzero(fresh):
                    lo, hi = 0, ef                # #{s < ef : bd[s] <= v}
                    while lo < hi:
                        mid = (lo + hi) // 2
                        lo, hi = (mid + 1, hi) if bd[mid] <= nd[m] \
                            else (lo, mid)
                    rank = sum(fresh[k] and (nd[k] < nd[m] or (
                        nd[k] == nd[m] and k < m)) for k in range(M0))
                    lb[m], slot[m] = lo, lo + rank
                nbd, nbi = np.full(ef, np.nan, np.float32), bi.copy()
                nbx, nhd = bx.copy(), np.full(ef, -1)
                nstage = np.full(M0, -1)
                for r, m in enumerate(np.flatnonzero(~fresh)):
                    nstage[nf + r] = stage[m]

                def put(p, v, i, x, h):
                    if p < ef:
                        assert np.isnan(nbd[p])   # each slot written once
                        nbd[p], nbi[p], nbx[p], nhd[p] = v, i, x, h
                    else:
                        nstage[p - ef] = h

                for m, p in slot.items():         # fresh m: lb_m + rank_m
                    put(p, nd[m], ids[m], False, stage[m])
                    mark(ids[m])
                for s in range(ef):               # s + #{m : lb_m <= s}
                    put(s + sum(v <= s for v in lb.values()), bd[s], bi[s],
                        bx[s] or s == j, hd[s])
                assert sorted([*nhd, *nstage]) == list(range(ef + M0))
                bd, bi, bx, hd, stage = nbd, nbi, nbx, nhd, nstage
                start = min(j, min(slot.values(), default=ef))
                h += 1
                e += nf
            out_i[q, :ef], out_d[q, :ef] = bi, bd
        hops[q], edges[q] = h, e
    return out_i, out_d, words, hops, edges


def _integer_graph(seed, R=256, M0=8, M=4, LU=5, empty_top=3, d=8, nq=6):
    """Integer coordinates (every fp32 sum exact, in any order) and
    duplicated rows and ids, so equal distances occur on every hop: the
    tie rules, not rounding, decide the beam.  Upper layers: the top
    `empty_top` of LU padded with -1 rows only (an empty padded layer),
    the others with neighbour rows on a shrinking set of nodes."""
    rng = np.random.default_rng(seed)
    C = rng.integers(-3, 4, size=(R, d)).astype(np.float32)
    C[R // 2:] = C[: R // 2]                     # every row twice
    neigh0 = rng.integers(0, R, size=(R, M0)).astype(np.int32)
    neigh0[:, 1] = neigh0[:, 0]                  # a duplicated id per row
    neigh0[rng.random((R, M0)) < 0.15] = -1
    ok = rng.random(R) > 0.05
    neigh_up = np.full((LU, R, M), -1, np.int32)
    for li in range(LU - empty_top):
        nodes = rng.choice(R, size=R // (4 << li), replace=False)
        rows = rng.choice(nodes, size=(len(nodes), M))
        rows[rng.random(rows.shape) < 0.2] = -1
        neigh_up[li, nodes] = rows
    Q = rng.integers(-3, 4, size=(nq, d)).astype(np.float32)
    D = ((C[None] - Q[:, None]) ** 2).sum(-1)
    entry = int(np.flatnonzero(ok & (neigh_up[0, :, 0] >= 0))[0])
    return neigh0, neigh_up, ok, C, Q, D, entry


@pytest.mark.parametrize("ef", [48, 64])
def test_kernel_rules_emulated_equal_beam_layer0(ef):
    """The layer-0 entry (expand_layer0) from given endpoints, with an
    empty graph's query: the emulated kernel equals the port's and the
    JAX walk's layer 0 bit for bit."""
    rng = np.random.default_rng(ef)
    neigh0, _, ok, C, Q, D, _ = _integer_graph(ef)
    nq, R = D.shape
    ep = rng.integers(0, R, size=nq).astype(np.int64)
    ep[2] = -1                                   # an empty graph's query
    ep_d = np.where(ep >= 0, D[np.arange(nq), np.maximum(ep, 0)], np.inf)
    ep_d = ep_d.astype(np.float32)
    args = dict(ef=ef, ef_cap=64, max_hops=256)

    want_i, want_d, want_w, want_h, want_e = _emulate_kernel(
        neigh0, None, ok, D, -1, ep=ep, ep_d=ep_d, **args)
    t = [torch.from_numpy(a) for a in (neigh0, ok, C, Q, ep, ep_d)]
    got_i, got_d, got_v, got_h, got_e = graph_expand.expand_layer0(*t, **args)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    vis = graph_expand.unpack_visited(torch.from_numpy(want_w.view(np.int32)),
                                      R)
    np.testing.assert_array_equal(got_v.numpy(), vis.numpy())
    assert want_h.max() > 4 and want_h[2] == 0
    # and the JAX walk's layer 0 agrees on the same inputs
    j = jtraverse.beam_layer0(
        jnp.asarray(neigh0), jnp.asarray(ok), (jnp.asarray(C),),
        jnp.asarray(Q), jnp.asarray(ep, jnp.int32), jnp.asarray(ep_d),
        jnp.int32(ef), kp=64, ef_cap=64, max_hops=256)
    np.testing.assert_array_equal(np.asarray(j[0]), want_i)
    np.testing.assert_array_equal(np.asarray(j[2]), vis.numpy())


@pytest.mark.parametrize("pool,svis", [(True, True), (False, False)])
@pytest.mark.parametrize("ef,ef_cap", [(48, 64), (64, 64), (48, 2048),
                                       (64, 2048)])
def test_walk_kernel_rules_emulated_equal_traverse(ef, ef_cap, pool, svis):
    """The fused walk (graph_walk): the start, the descent through 3 empty
    padded layers and 2 real ones, and layer 0, as the kernel runs them
    (with the adjacency pool and the on-chip bitmap, or neither), equal
    the port's traverse and the JAX traverse (XLA) bit for bit: ids,
    distances, visited, hops and edges."""
    neigh0, neigh_up, ok, C, Q, D, entry = _integer_graph(ef + ef_cap)
    R = neigh0.shape[0]
    max_hops = 4 * ef_cap
    want = _emulate_kernel(neigh0, neigh_up, ok, D, entry, ef, ef_cap,
                           max_hops, pool=pool, svis=svis)
    vis = graph_expand.unpack_visited(
        torch.from_numpy(want[2].view(np.int32)), R).numpy()
    want = (want[0], want[1], vis, want[3], want[4])
    assert want[3].min() > 5 and want[4].min() > 0
    kw = dict(kp=ef_cap, ef_cap=ef_cap, max_hops=max_hops, quant="f32",
              oblivious=False)
    arrs = (neigh0, neigh_up, ok, C, Q)
    for got in (_torch_walk(traverse.traverse, arrs, entry, ef, **kw),
                _jax_walk(arrs, entry, ef, **kw)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    t = [torch.from_numpy(a) for a in arrs]
    got = graph_expand.graph_walk(*t, entry, ef, ef_cap=ef_cap,
                                  max_hops=max_hops)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_walk_kernel_rules_emulated_on_an_empty_graph_and_a_bad_entry():
    """entry -1 (an empty graph), and an entry whose row is not ok: every
    query starts at ep = -1, with 0 hops and an empty beam."""
    neigh0, neigh_up, ok, C, Q, D, _ = _integer_graph(3)
    bad = int(np.flatnonzero(~ok)[0])
    kw = dict(kp=64, ef_cap=64, max_hops=256, quant="f32", oblivious=False)
    for entry in (-1, bad):
        want = _emulate_kernel(neigh0, neigh_up, ok, D, entry, 48, 64, 256)
        assert (want[0] == -1).all() and (want[3] == 0).all()
        got = _jax_walk((neigh0, neigh_up, ok, C, Q), entry, 48, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[3], want[3])
        assert not got[2].any() and not want[2].any()


def test_walk_plan_and_shared_memory():
    """The kernel's variant by shape (walk_plan): the bitmap on chip up to
    R = 2^20, the pool where it fits, groups of at most 32 rows, always
    within the card's per-block limit."""
    plan = graph_expand.walk_plan
    smem = graph_expand.walk_smem
    cases = {(2 ** 17, 16, 8, 128, 96): (16, True, True),
             (2 ** 20, 32, 16, 128, 96): (32, True, True),
             (2 ** 17, 32, 16, 960, 96): (32, True, True),
             (2 ** 21, 16, 8, 128, 96): (16, True, False),
             (2 ** 17, 16, 8, 128, 2048): (16, True, True),
             (2 ** 17, 32, 16, 128, 2048): (32, False, True),
             (2 ** 20, 32, 16, 960, 96): (32, True, False),
             (2 ** 17, 64, 16, 128, 96): (32, True, True)}
    for (R, M0, M, d, ef), want in cases.items():
        G, pool, svis = plan(R, M0, M, d, ef)
        assert (G, pool, svis) == want, (R, M0, M, d, ef)
        assert smem(ef, M0, M, d, G, pool, svis, R) <= 232448
    # the bitmap's words and the pool's rows are what they cost
    base = smem(96, 16, 8, 128, 16, False, False, 2 ** 17)
    assert smem(96, 16, 8, 128, 16, False, True, 2 ** 17) == base + 2 ** 14
    assert smem(96, 16, 8, 128, 16, True, False, 2 ** 17) == \
        base + (96 + 16) * 16 * 4
    with pytest.raises(ValueError, match="shared memory"):
        plan(2 ** 17, 16, 8, 60000, 96)


def test_unpack_visited_bit_order():
    words = torch.tensor([[1, 0, -2 ** 31], [6, 0, 0]], dtype=torch.int32)
    vis = graph_expand.unpack_visited(words, 70)
    assert vis.shape == (2, 70)
    assert vis[0].nonzero().flatten().tolist() == [0]
    assert vis[1].nonzero().flatten().tolist() == [1, 2]
    full = graph_expand.unpack_visited(words, 96)
    assert full[0].nonzero().flatten().tolist() == [0, 95]


# ---------------------------------------------------------------------------
# Engine parity: the port's GraphFilter engine against the JAX engine.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratio_k,ef_search,oblivious", [
    (8, 128, False), (6, 64, False), (8, 96, True)])
def test_engine_ids_stats_and_trace_equal_jax(setup, ratio_k, ef_search,
                                              oblivious):
    ds, jserver, index, Q, T = setup
    jgf = JGraphFilter(jserver.db.index, use_kernel=False,
                       oblivious=oblivious)
    tgf = GraphFilter(index, oblivious=oblivious)
    jeng = JEngine(jserver.db.C_sap, jserver.db.C_dce, backend=jgf)
    teng = SecureSearchEngine(jserver.db.C_sap, jserver.db.C_dce,
                              backend=tgf, device=CPU)
    want, wst = jeng.search_batch(Q, T, K, ratio_k=ratio_k,
                                  ef_search=ef_search)
    got, gst = teng.search_batch(Q, T, K, ratio_k=ratio_k,
                                 ef_search=ef_search)
    np.testing.assert_array_equal(got, want)
    for f in COUNTS:
        assert getattr(gst, f) == getattr(wst, f), f
    assert gst.backend == "graph" and gst.n_hops > 0
    np.testing.assert_array_equal(tgf.last_scan_trace, jgf.last_scan_trace)
    assert synth.recall_at_k(got, ds.gt, K) >= 0.9


def _adc_db(quant, index, Q):
    """The ADC scan arrays of GraphFilter.attach (codebook over the live
    CSR rows, codes padded to R) and the query operand, as numpy."""
    gf = JGraphFilter(index, quantization=quant, use_kernel=False)
    gf.attach(None)
    db = tuple(np.asarray(a) for a in gf._db)
    return db, np.asarray(gf._query_operand(np.asarray(Q, np.float32)))


@pytest.mark.parametrize("quant", ["int8", "pq8"])
@pytest.mark.parametrize("oblivious", [False, True])
def test_adc_walk_matches_jax(setup, quant, oblivious):
    """int8 / pq8 edge scoring: the torch walk (and the serving entry
    point, which routes ADC walks to it) equals the XLA walk: ids,
    visited, hops and edges exactly (the surrogates are exact, or summed
    in the same order)."""
    _, jserver, index, Q, _ = setup
    g = CSRGraph.from_hnsw(index)
    db, qop = _adc_db(quant, jserver.db.index, Q)
    ef_eff, ef_cap, max_hops = beam_plan(48, 64)
    kw = dict(kp=48, ef_cap=ef_cap, max_hops=max_hops, quant=quant,
              oblivious=oblivious)
    J = jnp.asarray
    want = [np.asarray(o) for o in jtraverse.graph_topk(
        J(g.neigh0), J(g.neigh_up), J(g.levels >= 0), tuple(map(J, db)),
        J(qop), jnp.int32(g.entry), jnp.int32(ef_eff), **kw)]
    T = torch.from_numpy
    for fn in (traverse.traverse, graph_ops.graph_topk):
        got = [o.numpy() for o in fn(
            T(g.neigh0), T(g.neigh_up), T(g.levels >= 0),
            tuple(T(np.array(a)) for a in db), T(np.array(qop)), g.entry,
            ef_eff, **kw)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quant", ["int8", "pq8"])
@pytest.mark.parametrize("oblivious", [False, True])
def test_adc_engine_ids_stats_and_trace_equal_jax(setup, quant, oblivious):
    ds, jserver, index, Q, T = setup
    jgf = JGraphFilter(jserver.db.index, quantization=quant,
                       use_kernel=False, oblivious=oblivious)
    tgf = GraphFilter(index, quantization=quant, oblivious=oblivious)
    jeng = JEngine(jserver.db.C_sap, jserver.db.C_dce, backend=jgf)
    teng = SecureSearchEngine(jserver.db.C_sap, jserver.db.C_dce,
                              backend=tgf, device=CPU)
    want, wst = jeng.search_batch(Q, T, K, ef_search=96)
    got, gst = teng.search_batch(Q, T, K, ef_search=96)
    np.testing.assert_array_equal(got, want)
    for f in COUNTS:
        assert getattr(gst, f) == getattr(wst, f), f
    assert gst.backend == f"adc-graph-{quant}"
    np.testing.assert_array_equal(tgf.last_scan_trace, jgf.last_scan_trace)
    for key, val in jgf.codebook.to_arrays().items():
        np.testing.assert_array_equal(tgf.codebook.to_arrays()[key], val)


def test_batched_matches_per_query_and_filter_attach(setup):
    _, jserver, index, Q, T = setup
    eng = SecureSearchEngine(jserver.db.C_sap, jserver.db.C_dce,
                             backend=GraphFilter(index), device=CPU)
    whole, _ = eng.search_batch(Q, T, K, ef_search=128)
    for i in range(0, len(Q), 3):
        one, _ = eng.search(Q[i], T[i], K, ef_search=128)
        np.testing.assert_array_equal(whole[i], one)
    # attach without an engine goes to the card, and raises without one
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GraphFilter(index).attach(jserver.db.C_sap)
    gf = GraphFilter(index)
    gf.attach(jserver.db.C_sap, types.SimpleNamespace(device=torch.device(CPU)))
    cand, valid, evals = gf.candidates(Q[:2], 20, 64)
    assert cand.shape == (2, 20) and valid.all() and evals > 2
    assert gf.last_scan_trace.shape == (2, gf.csr.R)


# ---------------------------------------------------------------------------
# Roles: the host-walk oracle, Server and build_system.
# ---------------------------------------------------------------------------

def test_host_walk_oracle_equals_jax_and_the_batched_filter(setup):
    _, jserver, index, Q, T = setup
    jeng = JEngine(jserver.db.C_sap, jserver.db.C_dce,
                   backend=JHNSWGraphFilter(jserver.db.index))
    teng = SecureSearchEngine(jserver.db.C_sap, jserver.db.C_dce,
                              backend=HNSWGraphFilter(index), device=CPU)
    want, wst = _quiet(jeng.search_batch, Q, T, K, ef_search=128)
    with pytest.warns(DeprecationWarning, match="parity oracle"):
        got, gst = teng.search_batch(Q, T, K, ef_search=128)
    np.testing.assert_array_equal(got, want)
    for f in ("filter_dist_evals", "filter_bytes_scanned",
              "refine_comparisons", "backend"):
        assert getattr(gst, f) == getattr(wst, f), f
    batched, _ = SecureSearchEngine(
        jserver.db.C_sap, jserver.db.C_dce, backend=GraphFilter(index),
        device=CPU).search_batch(Q, T, K, ef_search=128)
    np.testing.assert_array_equal(batched, got)


def test_server_search_insert_delete_equal_jax(setup):
    ds, jserver, _, Q, T = setup
    jdb = jppanns.EncryptedDatabase(
        C_sap=jserver.db.C_sap.copy(),
        index=JHNSW.from_arrays(jserver.db.index.to_arrays()),
        C_dce=jserver.db.C_dce.copy())
    tdb = ppanns.EncryptedDatabase(
        C_sap=jserver.db.C_sap.copy(),
        index=HNSW.from_arrays(jserver.db.index.to_arrays()),
        C_dce=jserver.db.C_dce.copy())
    js, ts = jppanns.Server(jdb), ppanns.Server(tdb, device=CPU)
    want, _ = _quiet(js.search_batch, Q, T, K)
    got, _ = _quiet(ts.search_batch, Q, T, K)
    np.testing.assert_array_equal(got, want)
    for refine in ("tournament", "heap"):
        want, wst = _quiet(js.search, Q[1], T[1], K, refine=refine)
        with pytest.warns(DeprecationWarning, match="legacy"):
            got, gst = ts.search(Q[1], T[1], K, refine=refine)
        np.testing.assert_array_equal(got, want)
        assert gst.refine_comparisons == wst.refine_comparisons
    # maintenance (§V-D): insert a near-copy of query 0's nearest row,
    # delete query 1's nearest, then search again
    new_sap = jserver.db.C_sap[int(ds.gt[0, 0])] + 1e-3
    new_dce = jserver.db.C_dce[int(ds.gt[0, 0])]
    assert ts.insert(new_sap, new_dce) == js.insert(new_sap, new_dce)
    victim = int(ds.gt[1, 0])
    ts.delete(victim)
    js.delete(victim)
    want, _ = _quiet(js.search_batch, Q, T, K)
    got, _ = _quiet(ts.search_batch, Q, T, K)
    np.testing.assert_array_equal(got, want)
    assert not (got == victim).any()
    _arrays_equal(tdb.index.to_arrays(), jdb.index.to_arrays())


def test_build_system_equals_jax():
    ds = synth.make_dataset("deep1m", n=200, n_queries=4, k_gt=10, seed=3,
                            d=16)
    kw = dict(beta_fraction=0.03, M=6, ef_construction=30, seed=3)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        _, tuser, tserver = ppanns.build_system(ds.base, device=CPU, **kw)
    _, juser, jserver = _quiet(jppanns.build_system, ds.base, **kw)
    _arrays_equal(tserver.db.index.to_arrays(), jserver.db.index.to_arrays())
    enc = [(tuser.encrypt_query(q), juser.encrypt_query(q))
           for q in ds.queries]
    for (tq, tt), (jq, jt) in enc:
        assert tq.tobytes() == jq.tobytes() and tt.tobytes() == jt.tobytes()
    Q = np.stack([t[0][0] for t in enc])
    T = np.stack([t[0][1] for t in enc])
    want, _ = _quiet(jserver.search_batch, Q, T, 5)
    got, _ = _quiet(tserver.search_batch, Q, T, 5)
    np.testing.assert_array_equal(got, want)
