"""The port's ADC slice against the JAX package's, on the CPU.

The same numpy inputs go through `repro` and `repro_torch` (CPU tensors,
so each kernel wrapper runs its plain PyTorch version).  Tolerances:

* codebooks, k-means and IVF indexes: bit-identical arrays;
* the plain K4 (`sq_adc_topk`): ids and int32 distances exactly equal to
  `repro.kernels.adc_topk.ref` (int32 arithmetic on both sides);
* the plain K5 (`pq_adc_topk`): ids equal to `ref.pq_knn` and float32
  distances bit-equal to `ref.pq_dists` (the same ascending subspace
  order of adds);
* the pool and oblivious scans: ids and validity exactly equal to
  `repro.kernels.adc_topk.ops` at d <= 346 (exact float32 surrogates);
* the engines: ids and SearchStats counts exactly equal to the JAX
  engine's (its XLA path on this host).

K4 is held to `adc_topk/ref.py`, not to the Pallas kernel: the interpret
run of that kernel is not the reference here
(tests/test_properties.py::test_sq_adc_kernel_property).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import dcpe as jdcpe
from repro.core import ivf as jivf
from repro.data import synth
from repro.kernels.adc_topk import ops as j_adc_ops
from repro.kernels.adc_topk import ref as j_adc_ref
from repro.serving import search_engine as jse
from repro_torch.core import adc, ivf, ppanns
from repro_torch.kernels import _build
from repro_torch.kernels.adc_topk import adc_topk
from repro_torch.kernels.adc_topk import ops as adc_ops
from repro_torch.kernels.adc_topk import ref as adc_ref
from repro_torch.serving import search_engine as se

K = 10
CPU = "cpu"
INT_BIG = 2 ** 30
COUNTS = ("filter_dist_evals", "refine_comparisons", "bytes_up",
          "bytes_down", "filter_bytes_scanned", "n_queries", "backend")


@pytest.fixture(autouse=True)
def no_kernel_launch(monkeypatch):
    """On the CPU no wrapper may reach the CUDA build or launch path."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached the kernel launch path")
    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Codebooks, k-means and the IVF index: bit-identical.
# ---------------------------------------------------------------------------

def _ciphertext_like(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = 40.0 * rng.standard_normal((8, d))
    return (centers[rng.integers(0, 8, n)]
            + 3.0 * rng.standard_normal((n, d))).astype(np.float32)


def test_sq_codebook_bit_identical_both_directions():
    C = _ciphertext_like(700, 24, 0)
    Q = _ciphertext_like(9, 24, 1) * 1.3          # some codes saturate
    t, j = adc.SQCodebook.train(C), jadc.SQCodebook.train(C)
    for a, b in zip(t.encode(C), j.encode(C)):
        _same(a, b)
    _same(t.encode_query(Q), j.encode_query(Q))
    codes, _ = t.encode(C)
    _same(t.decode(codes), j.decode(codes))
    assert t.code_bytes_per_vector() == j.code_bytes_per_vector() == 28
    for arrays, cls in ((j.to_arrays(), adc.SQCodebook),
                        (t.to_arrays(), jadc.SQCodebook)):
        back = cls.from_arrays(arrays)
        _same(back.offset, j.offset)
        assert back.scale == j.scale and back.trained_n == j.trained_n


@pytest.mark.parametrize("n,d,m", [(600, 16, 4), (300, 18, 16), (40, 8, 2)])
def test_pq_codebook_bit_identical_both_directions(n, d, m):
    """(300, 18, 16): pq_subspaces falls to 9; (40, 8, 2): fewer rows
    than 256 centroids, the duplicated-first-centroid fill."""
    C = _ciphertext_like(n, d, n)
    Q = _ciphertext_like(5, d, n + 1)
    t = adc.PQCodebook.train(C, m=m, seed=3)
    j = jadc.PQCodebook.train(C, m=m, seed=3)
    _same(t.centroids, j.centroids)
    assert t.m == j.m == jadc.pq_subspaces(d, m) == adc.pq_subspaces(d, m)
    _same(t.encode(C), j.encode(C))
    _same(t.lut(Q), j.lut(Q))
    _same(t.decode(t.encode(C)), j.decode(j.encode(C)))
    for arrays, cls in ((j.to_arrays(), adc.PQCodebook),
                        (t.to_arrays(), jadc.PQCodebook)):
        back = cls.from_arrays(arrays)
        _same(back.centroids, j.centroids)
        assert back.trained_n == j.trained_n


@pytest.mark.parametrize("chunk", [None, 100])
def test_pq_encode_in_chunks_is_bit_identical(monkeypatch, chunk):
    """The port walks the rows in chunks; at n larger than the chunk the
    codes equal the reference's single-pass encode."""
    rng = np.random.default_rng(7)
    if chunk is None:                         # the default chunk
        n, d, m = adc._ENCODE_CHUNK + 1000, 4, 4
    else:
        monkeypatch.setattr(adc, "_ENCODE_CHUNK", chunk)
        n, d, m = 1037, 16, 8
    cents = rng.standard_normal((m, 256, d // m)).astype(np.float32)
    C = rng.standard_normal((n, d)).astype(np.float32)
    assert n > adc._ENCODE_CHUNK
    _same(adc.PQCodebook(cents).encode(C), jadc.PQCodebook(cents).encode(C))


def test_codebook_helpers_match_reference():
    C = _ciphertext_like(300, 16, 4)
    for q in ("int8", "pq8"):
        t = adc.train_codebook(C, q, m=4, seed=1)
        j = jadc.train_codebook(C, q, m=4, seed=1)
        for key, val in j.to_arrays().items():
            _same(t.to_arrays()[key], val)
        back = adc.codebook_from_arrays(q, j.to_arrays())
        assert back.kind == q
        assert adc.default_refine_ratio(q) == jadc.default_refine_ratio(q)
    assert adc.default_refine_ratio(None) == 1.0
    assert adc.QUANTIZATIONS == jadc.QUANTIZATIONS
    for fn in (lambda m: m.train_codebook(C, "int4"),
               lambda m: m.codebook_from_arrays("int4", {})):
        with pytest.raises(ValueError, match="unknown quantization"):
            fn(adc)
        with pytest.raises(ValueError, match="unknown quantization"):
            fn(jadc)


def test_kmeans_and_ivf_index_bit_identical():
    X = _ciphertext_like(900, 12, 11)
    for k, iters, seed in ((16, 10, 0), (5, 3, 4)):
        tc, ta = ivf.kmeans(X, k, iters, seed)
        jc, ja = jivf.kmeans(X, k, iters, seed)
        _same(tc, jc)
        _same(ta, ja)
    t = ivf.IVFIndex(n_clusters=16, seed=2).build(X)
    j = jivf.IVFIndex(n_clusters=16, seed=2).build(X)
    _same(t.centroids, j.centroids)
    assert len(t.lists) == len(j.lists)
    for a, b in zip(t.lists, j.lists):
        _same(a, b)
    Q = _ciphertext_like(6, 12, 12)
    for q in Q:
        for nprobe in (1, 4):
            _same(t.probe(q, nprobe), j.probe(q, nprobe))
            _same(t.partition_of(q, nprobe), j.partition_of(q, nprobe))


# ---------------------------------------------------------------------------
# The plain K4 / K5 against the numpy oracle.
# ---------------------------------------------------------------------------

def _oracle(d_full, ok, kp, big):
    """lax.top_k of the masked row, with the exhaustion rule: slots whose
    distance is >= big are (big, -1)."""
    d = np.where(ok[None, :], d_full, big).astype(d_full.dtype)
    dist, idx = j_adc_ref._topk_ascending(d, min(kp, d.shape[1]))
    dist, idx = np.asarray(dist), np.asarray(idx).astype(np.int64)
    gone = dist >= big
    return np.where(gone, big, dist).astype(d_full.dtype), \
        np.where(gone, -1, idx)


def _sq_case(nq, n, d, seed, dup=0, far=False):
    """Random int8 queries and codes with their norms; `far`: codes of
    the opposite sign to the queries, so every surrogate is large (above
    2^24 at d = 960, where float32 merges neighbouring integers)."""
    rng = np.random.default_rng(seed)
    lo, hi = (100, 128) if far else (-127, 128)
    q8 = rng.integers(lo, hi, size=(nq, d)).astype(np.int8)
    lo, hi = (-127, -99) if far else (-127, 128)
    c8 = rng.integers(lo, hi, size=(n, d)).astype(np.int8)
    if dup:
        c8[n - dup:] = c8[:dup]
    cn = (c8.astype(np.int32) ** 2).sum(1).astype(np.int32)
    return q8, c8, cn


def _pq_case(nq, n, m, seed, dup=0):
    rng = np.random.default_rng(seed)
    lut = (rng.random((nq, m, 256)) * 100).astype(np.float32)
    lut[:, :, ::2] = np.round(lut[:, :, ::2])     # equal sums occur
    codes_t = rng.integers(0, 256, size=(m, n)).astype(np.uint8)
    if dup:
        codes_t[:, n - dup:] = codes_t[:, :dup]
    return lut, codes_t


SQ_CASES = [  # nq, n, d, kp, valid share, duplicated rows
    (4, 2 * adc_ref.CHUNK + 37, 16, 40, 1.0, 0),     # ragged n
    (3, 1500, 17, 25, 0.7, 0),                       # ragged d, ok mask
    (3, 100, 16, 30, 0.12, 0),                       # kp > valid rows
    (5, 3000, 12, 60, 1.0, 1500),                    # forced ties
    (2, 400, 960, 30, 0.9, 100),                     # int32 state: > 2^24
]


@pytest.mark.parametrize("nq,n,d,kp,valid,dup", SQ_CASES)
def test_plain_sq_adc_topk_equals_oracle(nq, n, d, kp, valid, dup):
    q8, c8, cn = _sq_case(nq, n, d, seed=n + d, dup=dup, far=d == 960)
    ok = np.random.default_rng(d).random(n) < valid
    dist, ids = adc_topk.sq_adc_topk(_t(q8), _t(c8), _t(cn), _t(ok), kp)
    want_d, want_i = _oracle(j_adc_ref.sq_dists(q8, c8, cn), ok, kp, INT_BIG)
    assert dist.dtype == torch.int32 and ids.dtype == torch.int64
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_array_equal(dist.numpy(), want_d)
    if d == 960:        # float32 would round these surrogates
        real = want_d[want_i >= 0]
        assert real.min() > 2 ** 24
        assert (real.astype(np.float32).astype(np.int64) != real).any()
    for row in ids.numpy():
        real = row[row >= 0]
        assert len(set(real.tolist())) == real.size == min(kp, ok.sum())
    if ok.all():        # the reference's unmasked knn is the same oracle
        _, ref_i = j_adc_ref.sq_knn(q8, c8, cn, kp)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("nq,n,m,kp,valid,dup", [
    (4, 2 * adc_ref.CHUNK + 37, 16, 40, 1.0, 0),
    (3, 1500, 8, 25, 0.7, 0),
    (3, 100, 16, 30, 0.12, 0),
    (5, 3000, 3, 60, 1.0, 1500),
])
def test_plain_pq_adc_topk_equals_oracle(nq, n, m, kp, valid, dup):
    lut, codes_t = _pq_case(nq, n, m, seed=n + m, dup=dup)
    ok = (np.random.default_rng(m).random(n) < valid).astype(np.int32)
    dist, ids = adc_topk.pq_adc_topk(_t(lut), _t(codes_t), _t(ok), kp)
    full = j_adc_ref.pq_dists(lut, codes_t)
    _same(adc_ref.pq_dists(_t(lut), _t(codes_t)).numpy(), full)
    want_d, want_i = _oracle(full, ok > 0, kp, np.float32(np.inf))
    np.testing.assert_array_equal(ids.numpy(), want_i)
    _same(dist.numpy(), want_d)
    if ok.all():
        _, ref_i = j_adc_ref.pq_knn(lut, codes_t, kp)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_i))


def test_sq_knn_and_pq_knn_match_the_reference_fallback():
    """ops.sq_knn / pq_knn (optional ok) against the JAX package's ops
    with its XLA fallback (use_kernel=False), at d <= 346."""
    q8, c8, cn = _sq_case(4, 3000, 64, seed=1, dup=300)
    ok = np.random.default_rng(2).random(3000) < 0.95
    for mask in (None, ok):
        kw = {} if mask is None else {"ok": _t(mask)}
        _, got = adc_ops.sq_knn(_t(q8), _t(c8), _t(cn), 50, **kw)
        jkw = {} if mask is None else {"ok": jnp.asarray(mask)}
        _, want = j_adc_ops.sq_knn(jnp.asarray(q8), jnp.asarray(c8),
                                   jnp.asarray(cn), 50, use_kernel=False,
                                   **jkw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        lut, codes_t = _pq_case(4, 3000, 8, seed=3)
        kw = {} if mask is None else {"ok": _t(mask)}
        _, got = adc_ops.pq_knn(_t(lut), _t(codes_t), 50, **kw)
        _, want = j_adc_ops.pq_knn(jnp.asarray(lut), jnp.asarray(codes_t),
                                   50, use_kernel=False, **jkw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The pool and oblivious scans.
# ---------------------------------------------------------------------------

def _pools(nq, n, seed):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(n, size=rng.integers(20, 300),
                               replace=False)) for _ in range(nq)]


@pytest.mark.parametrize("kp", [16, 200])
def test_pool_and_oblivious_scans_equal_reference(kp):
    n, d, m, nq = 1200, 96, 8, 5
    q8, c8, cn = _sq_case(nq, n, d, seed=5, dup=200)
    lut, codes_t = _pq_case(nq, n, m, seed=6, dup=200)
    pools = _pools(nq, n, 7)
    cand, valid = se.layout_pools(nq, pools, kp)
    jcand, jvalid = jse.layout_pools(nq, pools, kp)
    _same(cand, jcand)
    _same(valid, jvalid)
    member = se.pool_membership(nq, pools, n)
    _same(member, jse.pool_membership(nq, pools, n))
    J = jnp.asarray
    pairs = [
        (adc_ops.sq_pool_scan(_t(c8), _t(cn), _t(q8), _t(cand), _t(valid),
                              kp),
         j_adc_ops.sq_pool_scan(J(c8), J(cn), J(q8), J(cand), J(valid), kp)),
        (adc_ops.pq_pool_scan(_t(codes_t), _t(lut), _t(cand), _t(valid), kp),
         j_adc_ops.pq_pool_scan(J(codes_t), J(lut), J(cand), J(valid), kp)),
        (adc_ops.sq_oblivious_scan(_t(c8), _t(cn), _t(q8), _t(member), kp),
         j_adc_ops.sq_oblivious_scan(J(c8), J(cn), J(q8), J(member), kp)),
        (adc_ops.pq_oblivious_scan(_t(codes_t), _t(lut), _t(member), kp),
         j_adc_ops.pq_oblivious_scan(J(codes_t), J(lut), J(member), kp)),
    ]
    for (ids, v), (wids, wv) in pairs:
        np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
    # the oblivious scans pick the pool scans' candidates
    for (pi, pv), (oi, ov) in ((pairs[0][0], pairs[2][0]),
                               (pairs[1][0], pairs[3][0])):
        np.testing.assert_array_equal(torch.where(pv, pi, -1).numpy(),
                                      torch.where(ov, oi, -1).numpy())


def test_f32_ivf_scans_equal_reference():
    rng = np.random.default_rng(8)
    C = rng.standard_normal((900, 24)).astype(np.float32)
    Q = rng.standard_normal((4, 24)).astype(np.float32)
    pools = _pools(4, 900, 9)
    for got, want in (
            (se.scan_ivf_pools(_t(C), Q, pools, 40),
             jse.scan_ivf_pools(jnp.asarray(C), Q, pools, 40)),
            (se.scan_ivf_oblivious(_t(C), Q, pools, 40),
             jse.scan_ivf_oblivious(jnp.asarray(C), Q, pools, 40))):
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])


# ---------------------------------------------------------------------------
# The CUDA kernels' blocking, key packing and merge, emulated in torch.
# ---------------------------------------------------------------------------

TILE = adc_topk._TILE
EMPTY = torch.iinfo(torch.int64).max       # the kernels' ~0 as signed


def _state_len(kp):
    sc = 32
    while sc < kp:
        sc <<= 1
    return sc


def _sort_len(kp):
    s = 1
    while s < _state_len(kp) + 2 * TILE:
        s <<= 1
    return s


def _keys(d: torch.Tensor, ids: torch.Tensor, is_float: bool):
    """(orderable bits << 32) | id, shifted by -2^63 so that signed int64
    order is the kernels' unsigned order: int32 d gives d << 32 | id;
    float32 takes the sign-magnitude flip (-0 as +0)."""
    if is_float:
        u = (d + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        ordered = torch.where(u >= 2 ** 31, (~u) & 0xFFFFFFFF, u | 2 ** 31)
        return ((ordered - 2 ** 31) << 32) | ids
    return (d.to(torch.int64) << 32) | ids


def _unkey(keys: torch.Tensor, is_float: bool):
    empty = keys == EMPTY
    ids = torch.where(empty, -1, keys & 0xFFFFFFFF)
    ordered = (keys >> 32) + 2 ** 31
    if is_float:
        bits = torch.where(ordered >= 2 ** 31, ordered - 2 ** 31,
                           (~ordered) & 0xFFFFFFFF)
        signed = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
        d = signed.to(torch.int32).view(torch.float32)
        d = torch.where(empty, float("inf"), d)
    else:
        d = torch.where(empty, INT_BIG, ordered - 2 ** 31).to(torch.int32)
    return d, ids


def _select(tiles, kp: int):
    """One query's block-level selection: threshold filter, buffer,
    flush (a sort of [state | buffer]) when the next tile could overflow
    the buffer; the final flush's first kp keys."""
    S, SC = _sort_len(kp), _state_len(kp)
    state = torch.full((SC,), EMPTY, dtype=torch.int64)
    buf, thr = [], EMPTY
    flushes = 0

    def flush():
        nonlocal state, buf, thr, flushes
        seg = torch.cat([state, *buf, torch.full(
            (S - SC - sum(b.numel() for b in buf),), EMPTY,
            dtype=torch.int64)])
        state = torch.sort(seg).values[:SC]
        buf, thr = [], int(state[kp - 1])
        flushes += 1
    for tile in tiles:
        assert tile.numel() <= TILE
        buf.append(tile[tile < thr])
        assert sum(b.numel() for b in buf) <= S - SC       # no overflow
        if sum(b.numel() for b in buf) > S - SC - TILE:
            flush()
    flush()
    return state[:kp], flushes


def _emulate(d_full: torch.Tensor, ok: torch.Tensor, kp: int,
             chunk_rows: int, is_float: bool, big):
    """Stage 1 (per query and chunk of rows: tiles of TILE rows, masked
    and sentinel rows never offered) and stage 2 (the partials, in tiles
    of TILE keys)."""
    nq, n = d_full.shape
    kp = min(kp, n)
    ids = torch.arange(n, dtype=torch.int64)
    dists, out_i = [], []
    for q in range(nq):
        parts = []
        for r0 in range(0, n, chunk_rows):
            r1 = min(n, r0 + chunk_rows)
            tiles = []
            for t0 in range(r0, r1, TILE):
                t1 = min(r1, t0 + TILE)
                dq = d_full[q, t0:t1]
                keep = (ok[t0:t1] != 0) & (dq < big)
                tiles.append(_keys(dq[keep], ids[t0:t1][keep], is_float))
            parts.append(_select(tiles, kp)[0])
        flat = torch.cat(parts)
        top, _ = _select([flat[i:i + TILE] for i in
                          range(0, flat.numel(), TILE)], kp)
        d, i = _unkey(top, is_float)
        dists.append(d)
        out_i.append(i)
    return torch.stack(dists), torch.stack(out_i)


@pytest.mark.parametrize("nq,n,d,kp,valid,dup,chunk_rows", [
    (3, 5000, 16, 160, 0.99, 500, 1024),
    (2, 700, 17, 300, 1.0, 0, 256),      # kp > chunk: partials hold EMPTY
    (2, 100, 16, 30, 0.12, 0, 256),      # exhaustion
    (2, 3000, 960, 64, 1.0, 300, 2048),
])
def test_sq_kernel_blocking_emulated_equals_oracle(nq, n, d, kp, valid, dup,
                                                   chunk_rows):
    q8, c8, cn = _sq_case(nq, n, d, seed=n, dup=dup, far=d == 960)
    ok = np.random.default_rng(n).random(n) < valid
    full = j_adc_ref.sq_dists(q8, c8, cn)
    got_d, got_i = _emulate(_t(full), _t(ok), kp, chunk_rows, False,
                            INT_BIG)
    want_d, want_i = _oracle(full, ok, kp, INT_BIG)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)


@pytest.mark.parametrize("nq,n,m,kp,valid,dup,chunk_rows", [
    (3, 5000, 16, 320, 0.99, 500, 1024),
    (2, 100, 16, 30, 0.12, 0, 256),
    (2, 3000, 2, 64, 1.0, 0, 512),       # two subspaces: many equal sums
])
def test_pq_kernel_blocking_emulated_equals_oracle(nq, n, m, kp, valid, dup,
                                                   chunk_rows):
    lut, codes_t = _pq_case(nq, n, m, seed=n, dup=dup)
    ok = np.random.default_rng(n).random(n) < valid
    full = j_adc_ref.pq_dists(lut, codes_t)
    got_d, got_i = _emulate(_t(full), _t(ok), kp, chunk_rows, True,
                            float("inf"))
    want_d, want_i = _oracle(full, ok, kp, np.float32(np.inf))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    _same(got_d.numpy(), want_d)


def test_key_order_is_the_stable_sort_order():
    """Keys sort as (distance, id) for int32 and float32 distances,
    negative ones, zeros and equal values included."""
    d_int = torch.tensor([5, -3, 5, 0, -3, 2 ** 29, -(2 ** 29)],
                         dtype=torch.int32)
    d_flt = torch.tensor([1.5, -0.0, 0.0, -2.0, 1.5, 3e38, -3e38])
    for d, is_float in ((d_int, False), (d_flt, True)):
        ids = torch.arange(d.numel(), dtype=torch.int64)
        order = torch.sort(_keys(d, ids, is_float)).indices
        want = torch.sort(d + 0 if not is_float else d + 0.0,
                          stable=True).indices
        np.testing.assert_array_equal(order.numpy(), want.numpy())
        back, back_i = _unkey(_keys(d, ids, is_float), is_float)
        np.testing.assert_array_equal(back_i.numpy(), ids.numpy())
        assert torch.equal(back, d + 0.0 if is_float else d)


# ---------------------------------------------------------------------------
# The engines: IVF, ADC flat and IVF, on the same ciphertexts.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    ds = synth.make_dataset("deep1m", n=1200, n_queries=8, k_gt=30, seed=21)
    beta = jdcpe.suggest_beta(ds.base, fraction=0.03)
    owner = ppanns.DataOwner(d=ds.d, sap_beta=beta, seed=21)
    db = owner.encrypt_database(ds.base, build_index=False)
    user = ppanns.User(owner.share_keys())
    qs, ts = zip(*(user.encrypt_query(q) for q in ds.queries))
    return ds, db, np.stack(qs), np.stack(ts)


ENGINES = [
    dict(backend="ivf"),
    dict(backend="ivf", n_partitions=16, nprobe=2),
    dict(backend="flat", quantization="int8"),
    dict(backend="flat", quantization="pq8"),
    dict(backend="ivf", quantization="int8", n_partitions=16, nprobe=4),
    dict(backend="ivf", quantization="pq8", n_partitions=16, nprobe=4),
    dict(backend="flat", quantization="pq8", pq_m=8, refine_ratio=2.0),
]


@pytest.mark.parametrize("kw", ENGINES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_engine_ids_and_stats_equal_jax(corpus, kw):
    ds, db, Q, T = corpus
    jeng = jse.SecureSearchEngine(db.C_sap, db.C_dce, **kw)
    teng = se.SecureSearchEngine(db.C_sap, db.C_dce, device=CPU, **kw)
    for ratio_k, refine in ((8, "tournament"), (6, "none")):
        want, wst = jeng.search_batch(Q, T, K, ratio_k=ratio_k,
                                      refine=refine)
        got, gst = teng.search_batch(Q, T, K, ratio_k=ratio_k,
                                     refine=refine)
        np.testing.assert_array_equal(got, want)
        for f in COUNTS:
            assert getattr(gst, f) == getattr(wst, f), f
    want, _ = jeng.search(Q[3], T[3], K, refine="heap")
    got, _ = teng.search(Q[3], T[3], K, refine="heap")
    np.testing.assert_array_equal(got, want)
    if teng.backend.name.startswith("adc-flat"):
        code = teng.backend.codebook.code_bytes_per_vector()
        assert gst.filter_bytes_scanned == ds.n * code


def test_adc_filter_codebook_and_oversampling_equal_jax(corpus):
    ds, db, Q, _ = corpus
    for q in ("int8", "pq8"):
        jf = jse.ADCFilter(q, "ivf", n_partitions=16, use_kernel=False)
        tf = se.ADCFilter(q, "ivf", n_partitions=16)
        jf.attach(db.C_sap, None)
        tf.attach(db.C_sap, se.SecureSearchEngine(
            db.C_sap, db.C_dce, device=CPU))
        for key, val in jf.codebook.to_arrays().items():
            _same(tf.codebook.to_arrays()[key], val)
        _same(tf.ivf.centroids, jf.ivf.centroids)
        assert tf.name == jf.name and tf.oversampled(80) == jf.oversampled(80)
        cand, valid, evals = tf.candidates(Q, 80, 96)
        wc, wv, we = jf.candidates(Q, 80, 96)
        np.testing.assert_array_equal(cand.numpy(), wc)
        np.testing.assert_array_equal(valid.numpy(), wv)
        assert evals == we and tf.last_filter_bytes == jf.last_filter_bytes


def test_tiny_database_adc_fills_with_sentinels(corpus):
    """k' * ratio > n: -1 slots, never a fabricated or repeated id."""
    _, db, Q, T = corpus
    for q in ("int8", "pq8"):
        jeng = jse.SecureSearchEngine(db.C_sap[:7], db.C_dce[:7],
                                      quantization=q)
        teng = se.SecureSearchEngine(db.C_sap[:7], db.C_dce[:7],
                                     quantization=q, device=CPU)
        got, _ = teng.search_batch(Q[:2], T[:2], K)
        want, _ = jeng.search_batch(Q[:2], T[:2], K)
        np.testing.assert_array_equal(got, want)
        assert (got[:, 7:] == -1).all()
        assert sorted(got[0, :7].tolist()) == list(range(7))


@pytest.mark.parametrize("kw,match", [
    (dict(backend="ivf", quantization="int4"), "int8|pq8"),
    (dict(backend="bogus", quantization="int8"), "flat|ivf"),
    (dict(backend="hnsw", quantization="int8"), "HNSWGraphFilter"),
    (dict(backend="graph", quantization="pq8"), "GraphFilter"),
    (dict(backend="flat", quantization="int8", kind="ivf"), None),
])
def test_engine_refusals_match_jax(corpus, kw, match):
    _, db, _, _ = corpus
    errors = []
    for cls, extra in ((jse.SecureSearchEngine, {}),
                       (se.SecureSearchEngine, {"device": CPU})):
        with pytest.raises((ValueError, TypeError)) as info:
            cls(db.C_sap, db.C_dce, **kw, **extra)
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1])
    if match is not None:
        assert all(match in str(e) for e in errors)


def test_backend_instance_with_quantization_refused(corpus):
    _, db, _, _ = corpus
    with pytest.raises(ValueError, match="backend instance"):
        jse.SecureSearchEngine(db.C_sap, db.C_dce,
                               backend=jse.IVFScanFilter(),
                               quantization="int8")
    with pytest.raises(ValueError, match="backend instance"):
        se.SecureSearchEngine(db.C_sap, db.C_dce,
                              backend=se.IVFScanFilter(),
                              quantization="int8", device=CPU)
    with pytest.raises(ValueError, match="kind"):
        se.ADCFilter("int8", "graph")
