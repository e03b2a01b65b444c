"""The fused flat scan and the fused refine against the JAX package, on
the CPU.

The CUDA kernels of `csrc/l2_topk.cu` (`l2_topk.knn`) and
`csrc/dce_comp.cu` (`dce_comp.refine_topk`) run only on the card.  Here
their blocking and selection rules are emulated in torch, key for key,
and held against `repro.kernels.l2_topk.ops.knn` and
`repro.kernels.dce_comp.ops.batched_top_k_by_wins` (Pallas in interpret
mode) on identical numpy inputs; the new entries' plain versions, which
CPU tensors run, are held against the same functions and against the
JAX engine's `refine_candidates`.  Tolerances: ids exactly equal;
distances within 1e-5 relative (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dce as jdce
from repro.kernels.dce_comp import ops as j_dce_ops
from repro.kernels.l2_topk import ops as j_l2_ops
from repro.serving import search_engine as jse
from repro_torch.kernels import _build, common
from repro_torch.kernels.dce_comp import dce_comp
from repro_torch.kernels.dce_comp import ref as t_dce_ref
from repro_torch.kernels.l2_topk import l2_topk
from repro_torch.kernels.l2_topk import ops as t_l2_ops
from repro_torch.serving import search_engine as se
from test_torch_adc import (SMS, _keys, _makespan, _merge_runs, _old_plan,
                            _pow2, _Select, _state_len, _sweep_plans, _unkey)

L2_RTOL = 1e-5

# Mirrors csrc/l2_topk.cu and csrc/dce_comp.cu.
ROWS = l2_topk._ROWS           # rows of a scan tile
MIN_BUFFER = 128               # scan: buffer keys per query, at least
GROUPS, TJ = 16, 80            # refine: thread groups, j-tile columns


@pytest.fixture(autouse=True)
def no_kernel_launch(monkeypatch):
    """On the CPU no wrapper may reach the CUDA build or launch path."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached the kernel launch path")
    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# l2_topk.knn: stage 1 (row chunks, tiles of ROWS rows, a per-query running
# top-k' whose full buffer sends keys back to their threads until the block
# has flushed) and stage 2 (the chunks' sorted partials merged in runs,
# with a flush after each run).
# ---------------------------------------------------------------------------

def _emulate_knn(d_full: torch.Tensor, kp: int, chunk_rows: int,
                 floor=None):
    """The fused scan's selection over a (nq, n) float32 distance matrix,
    with `floor` (nq,) keys offering only the keys after the query's
    floor: -> (dists (nq, kp), ids (nq, kp)) decoded from the merged
    keys."""
    nq, n = d_full.shape
    kp = min(kp, n)
    ids = torch.arange(n, dtype=torch.int64)
    S1 = _pow2(_state_len(kp) + MIN_BUFFER)
    out_d, out_i = [], []
    for q in range(nq):
        parts = []
        for r0 in range(0, n, chunk_rows):
            r1 = min(n, r0 + chunk_rows)
            sel = _Select(kp, S1)
            for t0 in range(r0, r1, ROWS):
                t1 = min(r1, t0 + ROWS)
                keys = _keys(d_full[q, t0:t1], ids[t0:t1], True)
                if floor is not None:
                    keys = keys[keys > floor[q]]
                sel.offer_until_placed(keys)
            sel.flush()
            parts.append(sel.state[:kp])
        lists = torch.stack(parts)                       # (G, kp) sorted
        d, i = _unkey(_merge_runs(lists, kp), True)
        out_d.append(d)
        out_i.append(i)
    return torch.stack(out_d), torch.stack(out_i)


@pytest.mark.parametrize("nq,n,d,k,chunk_rows,dup", [
    (4, 3000, 33, 80, 1024, 300),    # duplicated rows across chunks
    (3, 1700, 128, 80, 512, 0),      # n not a multiple of the tile
    (2, 300, 128, 500, 512, 0),      # k' > n
    (3, 5000, 128, 250, 2048, 1000),  # many full buffers, ties
    (2, 2600, 33, 1024, 1024, 0),    # k' 1024
])
def test_knn_kernel_blocking_emulated_equals_jax(nq, n, d, k, chunk_rows,
                                                dup):
    """Integer-valued rows and queries: every distance is exact in any
    summation order, so the ids, ties to the lowest id, must equal the
    JAX package's and the distances too."""
    rng = np.random.default_rng(n + d + k)
    X = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    if dup:
        X[n - dup:] = X[:dup]                 # ids i and n - dup + i tie
    Q = rng.integers(-3, 4, size=(nq, d)).astype(np.float32)
    jd, ji = j_l2_ops.knn(jnp.asarray(Q), jnp.asarray(X), k, interpret=True)
    full = l2_topk.plain_pairwise_sq_dists(_t(Q), _t(X))
    got_d, got_i = _emulate_knn(full, k, chunk_rows)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(jd),
                               rtol=L2_RTOL, atol=0)


def test_knn_floor_passes_emulated_equal_jax():
    """k' 1600 > MAX_KP: two passes of 800 through `common.floor_passes`,
    the second offering only the keys after each query's last key of the
    first (which the merge leaves in floor_out): the joined lists equal
    the JAX package's knn at k' 1600, ties (duplicated rows) included."""
    nq, n, d, k = 3, 2500, 16, 1600
    rng = np.random.default_rng(k)
    X = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    X[n - 400:] = X[:400]
    Q = rng.integers(-3, 4, size=(nq, d)).astype(np.float32)
    jd, ji = j_l2_ops.knn(jnp.asarray(Q), jnp.asarray(X), k, interpret=True)
    full = l2_topk.plain_pairwise_sq_dists(_t(Q), _t(X))
    calls = []

    def one_pass(kp, floor_in, floor_out):
        calls.append((kp, floor_in is None))
        got = _emulate_knn(full, kp, 1024, floor=floor_in)
        floor_out.copy_(_keys(got[0][:, -1], got[1][:, -1], True))
        return got

    got_d, got_i = common.floor_passes(k, l2_topk.MAX_KP, nq, one_pass,
                                       float("inf"), "cpu")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(jd),
                               rtol=L2_RTOL, atol=0)
    assert calls == [(800, True), (800, False)]
    # the wrapper's plain version (CPU tensors) gives the same ids
    _, plain_i = l2_topk.knn(_t(Q), _t(X), k)
    np.testing.assert_array_equal(plain_i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n,d,k", [(2000, 128, 80), (700, 33, 40)])
def test_knn_kernel_blocking_emulated_on_real_valued_rows(n, d, k):
    """Gaussian rows at DCPE-like magnitudes: ids equal to the JAX
    package's, distances within 1e-5 relative."""
    rng = np.random.default_rng(n + d)
    X = (1024.0 * rng.standard_normal((n, d))).astype(np.float32)
    Q = (1024.0 * rng.standard_normal((5, d))).astype(np.float32)
    jd, ji = j_l2_ops.knn(jnp.asarray(Q), jnp.asarray(X), k, interpret=True)
    full = l2_topk.plain_pairwise_sq_dists(_t(Q), _t(X))
    got_d, got_i = _emulate_knn(full, k, 512)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(jd), rtol=L2_RTOL)


def test_knn_selection_flushes_on_a_full_buffer():
    """Descending distances: every row beats the ones before, so each
    tile offers more keys than the buffer holds and the threads must keep
    and re-offer them; the result is still the exact top-k'."""
    n, kp = 3000, 80
    d = torch.arange(n, 0, -1, dtype=torch.float32)[None]
    sel = _Select(kp, _pow2(_state_len(kp) + MIN_BUFFER))
    ids = torch.arange(n, dtype=torch.int64)
    for t0 in range(0, n, ROWS):
        sel.offer_until_placed(_keys(d[0, t0:t0 + ROWS], ids[t0:t0 + ROWS],
                                     True))
    sel.flush()
    assert sel.flushes > n // ROWS
    _, got = _unkey(sel.state[:kp], True)
    np.testing.assert_array_equal(got.numpy(), np.arange(n - 1, n - kp - 1,
                                                         -1))


@pytest.mark.parametrize("chunk", [64, 4096])
def test_plain_knn_is_the_reference_chunked_scan(chunk):
    """The plain version that CPU tensors run equals the JAX package's
    knn at the same chunk, and the full stable sort."""
    rng = np.random.default_rng(chunk)
    Q = rng.standard_normal((6, 20)).astype(np.float32)
    X = rng.standard_normal((777, 20)).astype(np.float32)
    jd, ji = j_l2_ops.knn(jnp.asarray(Q), jnp.asarray(X), 30, chunk=chunk,
                          interpret=True)
    td, ti = t_l2_ops.knn(_t(Q), _t(X), 30, chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _, ri = l2_topk.plain_knn(_t(Q), _t(X), 30, chunk=chunk)
    np.testing.assert_array_equal(ri.numpy(), ti.numpy())
    assert not any(l2_topk.launches.values())


# ---------------------------------------------------------------------------
# The block plan of the fused scans (common.block_plan): the rows cut into G
# chunks of whole tiles over the card's slots, SMs x resident blocks.
# ---------------------------------------------------------------------------

def test_block_plan_is_the_least_makespan_of_every_G():
    """The rule tries only the least G of each chunk length; over every G
    from 1 to the tiles it finds the same least makespan, ties to the
    smaller G."""
    for groups in (1, 3, 32, 67, 128, 200):
        for n in (1, 511, 5000, 100_000, 10 ** 6):
            for slots, c in ((132, 0.0), (132, 2.0), (264, 8.0), (7, 1.5)):
                tiles = -(-n // 512)
                costs = [(_makespan(groups, -(-tiles // G), G, slots, c), G)
                         for G in range(1, tiles + 1)]
                cost, G = min(costs)
                plan = common.block_plan(groups, n, 512, slots, c)
                per = plan.chunk_rows // 512
                assert per == -(-tiles // G) and plan.G == -(-tiles // per)
                assert _makespan(groups, per, plan.G, slots, c) == cost


@pytest.mark.parametrize("resident", [1, 2])
def test_knn_block_plans_over_a_sweep_of_shapes(resident):
    _sweep_plans(ROWS, lambda kp: 32 if kp <= 256 else 8,
                 l2_topk._CHUNK_COST, resident)


def test_block_plan_one_wave_is_not_always_least():
    """Where the groups do not divide the slots, a second wave of more
    chunks can beat the plan of one wave: 67 groups (nq 536 at k' 800)
    over 1M rows take 1,954 tile-times in one wave of 67 blocks, and
    2 x 652 in two waves of 201."""
    plan = common.block_plan(67, 10 ** 6, ROWS, SMS, l2_topk._CHUNK_COST)
    assert plan.G * 67 > SMS
    assert _makespan(67, plan.chunk_rows // ROWS, plan.G, SMS,
                     l2_topk._CHUNK_COST) < 1954 + l2_topk._CHUNK_COST


def _mock_l2_entries(monkeypatch, resident=1):
    """The C entries _plan calls, answered as csrc/l2_topk.cu would; the
    occupancy entry answers `resident` and records its arguments."""
    asked = []

    class Props:
        multi_processor_count = SMS
        shared_memory_per_block_optin = l2_topk._SHARED_LIMIT

    def function(name, argtypes):
        if name == "repro_l2_knn_smem":
            return lambda kp, code: 0
        if name == "repro_l2_knn_queries_per_block":
            return lambda kp: 32 if kp <= 256 else 8
        assert name == "repro_l2_knn_blocks_per_sm" and len(argtypes) == 4
        return lambda *a: asked.append(a) or resident
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    l2_topk._plan.cache_clear()
    return asked


def test_knn_plan_mirrors_the_kernel(monkeypatch):
    """The cells' plans on 132 SMs at one block an SM: flat k10 (k' 80)
    one wave of 32 x 4 blocks, 489 tiles each (the old rule: 32 x 5 in
    two waves); flat k100 (k' 800, 8 queries a block) 128 x 1; nq 32 as
    before, 131 chunks of 15 tiles; scan_16m (2^24 rows, k' 128) 8 whole
    waves of 32 x 33 blocks, 993 tiles each (4 chunks: 8,192).
    The occupancy entry is asked for the launched variant (k', element
    code, later pass), once a shape: the plan is cached."""
    asked = _mock_l2_entries(monkeypatch)
    try:
        assert l2_topk._plan(1024, 10 ** 6, 80, 0, None)[:2] == (489 * 512,
                                                                 4)
        assert _old_plan(32, 10 ** 6, ROWS, SMS) == (391, 5)
        assert l2_topk._plan(1024, 10 ** 6, 800, 0, None)[:2] == (
            1954 * 512, 1)
        assert _old_plan(128, 10 ** 6, ROWS, SMS) == (977, 2)
        assert l2_topk._plan(32, 10 ** 6, 80, 0, None)[:2] == (7680, 131)
        assert l2_topk._plan(1024, 2 ** 24, 128, 1, None)[:2] == (
            993 * 512, 33)
        l2_topk._plan(1024, 10 ** 6, 80, 0, None)
        l2_topk._plan(9, 5000, 800, 2, None, True)
        assert asked == [(80, 0, 0, 0), (800, 0, 0, 0), (80, 0, 0, 0),
                         (128, 1, 0, 0), (800, 2, 1, 0)]
        plan = l2_topk._plan(1024, 10 ** 6, 80, 0, None)
        assert plan.work_tiles == 32 * 1954
        assert plan.slot_tiles == 132 * 489
        with pytest.raises(ValueError, match="limit"):
            l2_topk._plan(1, 10, l2_topk.MAX_KP + 1, 0, None)
    finally:
        l2_topk._plan.cache_clear()


def test_knn_plan_counts_resident_blocks(monkeypatch):
    """Two blocks an SM give 264 slots: the flat k10 shape then takes
    one wave of 32 x 8 blocks; no block on an SM is refused."""
    _mock_l2_entries(monkeypatch, resident=2)
    try:
        assert l2_topk._plan(1024, 10 ** 6, 80, 0, None).G == 8
        _mock_l2_entries(monkeypatch, resident=0)
        with pytest.raises(RuntimeError, match="no block fits"):
            l2_topk._plan(1024, 10 ** 6, 80, 0, None)
    finally:
        l2_topk._plan.cache_clear()


def test_meta_knn_partials_follow_the_plan(monkeypatch):
    """knn on meta tensors allocates each pass's (nq, G, k') partial
    buffer with the plan's G at 132 SMs, one block each."""
    shapes = []
    empty = torch.empty

    def recording(*size, **kw):
        t = empty(*size, **kw)
        if t.dim() == 3:
            shapes.append(tuple(t.shape))
        return t
    monkeypatch.setattr(torch, "empty", recording)
    for nq, n, k in ((1024, 10 ** 6, 80), (1024, 10 ** 6, 800),
                     (32, 10 ** 6, 80), (1024, 2 ** 24, 128),
                     (64, 10 ** 6, 1600)):
        shapes.clear()
        l2_topk.knn(torch.empty((nq, 128), device="meta"),
                    torch.empty((n, 128), device="meta"), k)
        want = [(nq, common.block_plan(-(-nq // (32 if kp <= 256 else 8)), n,
                                       ROWS, SMS, l2_topk._CHUNK_COST).G,
                 kp) for kp in common.pass_sizes(k, l2_topk.MAX_KP)]
        assert shapes == want
    assert shapes == [(64, 16, 800)] * 2       # 8 groups x 16: one wave
    assert not any(l2_topk.launches.values())


@pytest.mark.parametrize("G", [1, 4, 5, 33])
def test_knn_blocking_emulated_is_the_same_at_any_G(G):
    """Chunks of whole tiles: every row's distance comes out of the same
    tile, and keys are distinct, so the emulated scan + merge gives the
    same ids and distances at G 1, 4, 5 and 33 (ties included), equal to
    the plain chunked merge."""
    nq, d, k = 3, 16, 80
    tiles = 66
    n = tiles * ROWS - 100
    rng = np.random.default_rng(7)
    X = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    X[n - 600:] = X[:600]
    Q = rng.integers(-3, 4, size=(nq, d)).astype(np.float32)
    full = l2_topk.plain_pairwise_sq_dists(_t(Q), _t(X))
    chunk_rows = -(-tiles // G) * ROWS
    assert -(-n // chunk_rows) == G
    got_d, got_i = _emulate_knn(full, k, chunk_rows)
    want_d, want_i = l2_topk.plain_knn(_t(Q), _t(X), k)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


# ---------------------------------------------------------------------------
# dce_comp.refine_topk: stage 1 (a block per query and TI rows, win counts
# summed over 80-column j-tiles and the 16 column threads) and stage 2 (a
# slot's rank = #{w_j > w_i} + #{j < i : w_j = w_i}, written below k).
# ---------------------------------------------------------------------------

def _cipher_sets(B, N, n, d, seed, dup=0, invalid=0.0):
    """Real DCE ciphertexts of N rows, B candidate sets of n slots read
    through a shuffled cand (`dup` slots repeat another slot's id, so
    wins tie), an `invalid` share of slots masked (half of them -1, as
    the graph filter leaves them), query 0 with 3 valid slots."""
    rng = np.random.default_rng(seed)
    key = jdce.keygen(d, seed=seed)
    C = jdce.encrypt(rng.standard_normal((N, d)), key, seed=seed + 1)
    T = jdce.trapgen(rng.standard_normal((B, d)), key, seed=seed + 2)
    cand = np.stack([rng.permutation(N)[:n] for _ in range(B)])
    if dup:
        cand[:, n - dup:] = cand[:, :dup]
    valid = rng.random((B, n)) >= invalid
    if invalid:
        valid[0] = False
        valid[0, :3] = True
    return (C.astype(np.float32), cand.astype(np.int64),
            T.astype(np.float32), valid)


def _emulate_refine(C_dce, cand, T, valid, k, RI):
    """Stage 1 per (query, TI-row tile, 64-column j-tile) and stage 2 by
    the rank rule -> (ids (B, k), local slots (B, k), wins (B, n))."""
    B, n = cand.shape
    k = min(k, n)
    Cc = C_dce[cand.clamp(min=0)]
    Z = t_dce_ref.batched_z_matrix(Cc, T)
    TI = GROUPS * RI
    wins = torch.zeros((B, n), dtype=torch.int32)
    vj = torch.ones((B, n), dtype=torch.bool) if valid is None else valid
    for b in range(B):
        for i0 in range(0, n, TI):
            for j0 in range(0, n, TJ):
                i = torch.arange(i0, min(n, i0 + TI))[:, None]
                j = torch.arange(j0, min(n, j0 + TJ))[None, :]
                won = (Z[b, i, j] < 0) & (i != j) & vj[b, j]
                wins[b, i0:i0 + TI] += won.sum(1, dtype=torch.int32)
    wins = torch.where(vj, wins, -1)
    ids = torch.empty((B, k), dtype=torch.int64)
    local = torch.empty((B, k), dtype=torch.int64)
    for b in range(B):
        w = wins[b]
        for i in range(n):
            rank = int((w > w[i]).sum() + (w[:i] == w[i]).sum())
            if rank < k:
                local[b, rank] = i
                ids[b, rank] = -1 if w[i] < 0 else cand[b, i]
    return ids, local, wins


@pytest.mark.parametrize("B,n,k,dup,invalid,RI", [
    (3, 40, 12, 0, 0.0, 1),
    (4, 80, 10, 10, 0.0, 2),         # tied wins
    (4, 80, 10, 0, 0.3, 2),          # masked slots, query 0 below k
    (2, 100, 60, 20, 0.2, 5),        # k above the valid count, ties
])
def test_refine_kernel_ranking_emulated_equals_jax(B, n, k, dup, invalid,
                                                   RI):
    C, cand, T, valid = _cipher_sets(B, 400, n, 24, seed=n + k, dup=dup,
                                     invalid=invalid)
    v = valid if invalid else None
    want_local = np.asarray(j_dce_ops.batched_top_k_by_wins(
        jnp.asarray(C[cand]), jnp.asarray(T), k,
        valid=None if v is None else jnp.asarray(v), interpret=True))
    ids, local, wins = _emulate_refine(_t(C), _t(cand), _t(T),
                                       None if v is None else _t(v), k, RI)
    np.testing.assert_array_equal(local.numpy(), want_local)
    want_ids = np.take_along_axis(cand, want_local, axis=1)
    if v is not None:
        want_ids = np.where(np.take_along_axis(v, want_local, axis=1),
                            want_ids, -1)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    got, got_wins = dce_comp.refine_topk(_t(C), _t(cand), _t(T),
                                         None if v is None else _t(v), k,
                                         return_wins=True)
    np.testing.assert_array_equal(got.numpy(), want_ids)
    np.testing.assert_array_equal(got_wins.numpy(), wins.numpy())


@pytest.mark.parametrize("dup,invalid,k", [(0, 0.0, 10), (15, 0.2, 10),
                                          (0, 0.5, 70)])
def test_refine_candidates_equals_jax(dup, invalid, k):
    """The engine's refine (one refine_topk call; on CPU tensors its plain
    version) against the JAX engine's `refine_candidates`; invalid slots
    hold -1 or a stale id, neither of which may be returned."""
    C, cand, T, valid = _cipher_sets(5, 600, 80, 32, seed=k + dup,
                                     dup=dup, invalid=invalid)
    if invalid:
        cand = np.where(valid | (np.arange(80) % 2 == 0), cand, -1)
    v = valid if invalid else None
    want = np.asarray(jse.refine_candidates(
        jnp.asarray(C), jnp.asarray(cand), jnp.asarray(T),
        None if v is None else jnp.asarray(v), k))
    got = se.refine_candidates(_t(C), _t(cand), _t(T),
                               None if v is None else _t(v), k)
    assert got.dtype == torch.int64 and got.shape == (5, min(k, 80))
    np.testing.assert_array_equal(got.numpy(), want)
    if v is not None:
        assert (got[0, 3:] == -1).all()       # query 0: 3 real slots
    assert not any(dce_comp.launches.values())
