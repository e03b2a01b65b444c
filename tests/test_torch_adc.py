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
from repro_torch.kernels import _build, common
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


def _query_rows(cb, nq: int, seed: int) -> dict:
    """Query sets of nq rows on the grid of cb: ciphertext-like rows,
    rows on half-steps offset + (j + 0.5) scale (j in [-128, 127], so
    both ends clip), rows 128-1000 steps out (saturating), the offset."""
    rng = np.random.default_rng(seed)
    d, off, s = cb.d, cb.offset.astype(np.float64), cb.scale
    steps = rng.integers(-128, 128, (nq, d)) + 0.5
    far = rng.choice([-1.0, 1.0], (nq, d)) * rng.uniform(128, 1000, (nq, d))
    return {"data": _ciphertext_like(nq, d, seed),
            "half_steps": (off + steps * s).astype(np.float32),
            "saturating": (off + far * s).astype(np.float32),
            "offset": np.repeat(cb.offset[None], nq, axis=0)}


@pytest.mark.parametrize("nq", [1, 33, 1024])
@pytest.mark.parametrize("d", [128, 960, 100])
def test_sq_encode_queries_equals_encode_query(nq, d):
    """The int8 query operand as the port makes it on the host (the plain
    `sq_encode_queries`, its dispatching wrapper, `SQCodes.query_operand`)
    equals the codebook's `encode_query` bit for bit, the port's and the
    JAX package's, on a trained grid and on a dyadic one (scale 0.25,
    offsets in eighths), where every half-step is exact in float32 and
    must round to even."""
    from repro_torch.core import adc_codes
    C = _ciphertext_like(500, d, d)
    rng = np.random.default_rng(d + nq)
    dyadic = (rng.integers(-400, 400, d) / 8.0).astype(np.float32)
    books = {"trained": (adc.SQCodebook.train(C),
                         jadc.SQCodebook.train(C)),
             "dyadic": (adc.SQCodebook(dyadic, 0.25),
                        jadc.SQCodebook(dyadic, 0.25))}
    cpu = torch.device(CPU)
    for t, j in books.values():
        codes = adc_codes.make("int8")
        codes.codebook = t
        offset = torch.from_numpy(t.offset)
        for Q in _query_rows(t, nq, d + nq).values():
            want = t.encode_query(Q)
            _same(want, j.encode_query(Q))
            for got in (adc_ref.sq_encode_queries(_t(Q), offset, t.scale),
                        adc_topk.sq_encode_queries(_t(Q), offset, t.scale),
                        codes.query_operand(Q, cpu)):
                _same(got.numpy(), want)
    t = books["dyadic"][0]
    half = _query_rows(t, nq, 0)["half_steps"]
    j = (half.astype(np.float64) - t.offset) / t.scale - 0.5
    assert (j == np.round(j)).all()                  # exact half-steps
    even = np.clip(np.where(j % 2 == 0, j, j + 1), -127, 127)
    _same(t.encode_query(half), even.astype(np.int8))


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

TILE = adc_topk._TILE                      # rows of a K4 / K5 tile
WARPS = {"sq": 16, "pq": 8}                # warps of a K4 / K5 block
EMPTY = torch.iinfo(torch.int64).max       # the kernels' ~0 as signed
# Mirrors csrc/adc_topk.cu and csrc/topk_select.cuh.
BUFFER = 256                   # buffer keys a query (32 BUF_E)
SQ_KS = 64                     # K4: depth bytes a staged slice
SQ_SLICE = 128                 # K4's TMA route: depth bytes a stage
THREADS = 256
RUN = 8                        # merge_runs: keys read per list a round
MERGE_KEYS = 4                 # merge_runs: keys a thread holds a batch
SHARED_LIMIT = adc_topk._SHARED_LIMIT


def _pow2(n):
    s = 1
    while s < n:
        s <<= 1
    return s


def _state_len(kp):
    return max(32, _pow2(kp))


def _scan_state_len(kp):
    return max(_state_len(kp), BUFFER)


def _smem(kind, qb, kp, width):
    """csrc/adc_topk.cu's repro_adc_smem_bytes."""
    select = qb * (_scan_state_len(kp) + BUFFER) * 8 + qb * 12
    if kind == "pq":
        return select + qb * width * 256 * 4
    stages = 4 if kp <= 512 else 3
    return select + stages * (TILE["sq"] + qb) * (SQ_KS + 16)


def _tma_smem(qb, kp, d, qreg, stages):
    """csrc/adc_topk.cu's repro_sq_tma_smem_bytes: the selection, the
    1024-byte alignment slack, the ring of 256 x 128-byte stages, the
    queries where they are not in registers, two barriers a stage."""
    select = qb * (_scan_state_len(kp) + BUFFER) * 8 + qb * 12
    queries = 0 if qreg else qb * -(-d // SQ_SLICE) * SQ_SLICE
    return select + 1024 + stages * TILE["sq"] * SQ_SLICE + queries + \
        16 * stages


def _route(n, d, kp, aligned=True):
    """The route the wrapper takes at this shape on the H100 (its opt-in
    shared memory)."""
    return adc_topk.sq_route(n, d, min(kp, adc_topk.MAX_KP), aligned,
                             _tma_smem, SHARED_LIMIT)


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


class _Segment:
    """One query on the merge_buffers route: a sorted state of SC keys, a
    buffer of BUFFER keys from the start, a threshold.  `put` returns the
    keys below the threshold that found the buffer full (their threads keep
    them); `merge` is merge_segment: the SC smallest of state and buffer."""

    def __init__(self, kp):
        self.kp, self.SC = kp, _scan_state_len(kp)
        self.state = torch.full((self.SC,), EMPTY, dtype=torch.int64)
        self.buf = torch.empty(0, dtype=torch.int64)
        self.thr = EMPTY
        self.merges = self.refused = 0

    def put(self, keys):
        below = keys[keys < self.thr]
        room = BUFFER - self.buf.numel()
        self.buf = torch.cat([self.buf, below[:room]])
        self.refused += below[room:].numel()
        return below[room:]

    def full(self):
        return self.buf.numel() >= BUFFER

    def merge(self):
        assert self.buf.numel() <= BUFFER
        self.state = torch.sort(torch.cat([self.state, self.buf])).values
        self.state = self.state[:self.SC]
        self.buf = torch.empty(0, dtype=torch.int64)
        self.thr = int(self.state[self.kp - 1])
        self.merges += 1


def _merge_due(segs, warps):
    """merge_buffers(all=false): every full buffer, and as many of the
    fullest others (most keys, then the lower segment) as fill the last
    round of `warps` merges."""
    full = sum(s.full() for s in segs)
    slots = -(-full // warps) * warps
    order = sorted(range(len(segs)), key=lambda q: (-segs[q].buf.numel(), q))
    for q in order[:slots]:
        if segs[q].buf.numel():
            segs[q].merge()


def _scan_block(tiles, kp, warps):
    """Stage 1 of one block: `tiles` is a list over the chunk's tiles of
    per-query key lists (valid rows, below the sentinel).  Each tile: every
    thread offers its keys; while any key is left over or a buffer is
    full, the buffers due are merged and the left-over keys are offered
    again.  At the end every buffer that holds a key is merged.  -> the
    segments."""
    segs = [_Segment(kp) for _ in tiles[0]] if tiles else []
    for tile in tiles:
        pend = list(tile)
        while True:
            pend = [s.put(k) for s, k in zip(segs, pend)]
            if not any(k.numel() for k in pend) and not any(
                    s.full() for s in segs):
                break
            _merge_due(segs, warps)
    for s in segs:
        if s.buf.numel():
            s.merge()
    return segs


class _Select:
    """One query's segment on the flush route: a state of SC keys, a
    buffer of S - SC (all S until the first flush, while the state is
    empty), a threshold; `put` keeps what does not fit, as a thread does."""

    def __init__(self, kp, S):
        self.kp, self.S, self.SC = kp, S, _state_len(kp)
        self.state = torch.full((self.SC,), EMPTY, dtype=torch.int64)
        self.buf = torch.empty(0, dtype=torch.int64)
        self.thr = EMPTY
        self.off = 0
        self.flushes = 0

    def put(self, keys):
        """Offer keys (one round); returns those that found the buffer
        full (below the threshold, not yet placed)."""
        below = keys[keys < self.thr]
        room = self.S - self.off - self.buf.numel()
        self.buf = torch.cat([self.buf, below[:room]])
        return below[room:]

    def flush(self):
        seg = torch.cat([self.state[:self.off], self.buf])
        self.state = torch.sort(seg).values[:self.SC]
        self.state = torch.cat([self.state, torch.full(
            (self.SC - self.state.numel(),), EMPTY, dtype=torch.int64)])
        self.off = self.SC
        self.buf = torch.empty(0, dtype=torch.int64)
        self.thr = int(self.state[self.kp - 1])
        self.flushes += 1

    def offer_until_placed(self, keys):
        while True:
            keys = self.put(keys)
            if keys.numel() == 0:
                return
            self.flush()


def _merge_runs(lists: torch.Tensor, kp: int):
    """Select::merge_runs over (G, kp) sorted partial lists: runs of RUN
    keys of every list a round (list-major), in batches of THREADS *
    MERGE_KEYS keys, a flush after each round, stopping after a round in
    which no key was below the threshold; one list is the answer as it
    is.  -> the kp smallest keys."""
    if lists.shape[0] == 1:      # one list: it is the answer
        return lists[0, :kp]
    batch = min(lists.shape[0] * RUN, THREADS * MERGE_KEYS)
    sel = _Select(kp, _pow2(_state_len(kp) + batch))
    for p0 in range(0, kp, RUN):
        run = lists[:, p0:p0 + RUN].reshape(-1)
        below = False
        for b0 in range(0, run.numel(), THREADS * MERGE_KEYS):
            batch = run[b0:b0 + THREADS * MERGE_KEYS]
            below |= bool((batch < sel.thr).any())
            sel.offer_until_placed(batch)
        if not below:            # every later key of a list is larger
            break
        sel.flush()              # tighten the threshold for the next run
    return sel.state[:kp]


def _emulate(d_full: torch.Tensor, ok: torch.Tensor, kp: int, qb: int,
             chunk_rows: int, kind: str, big, floor=None):
    """Both stages of K4 (kind "sq") or K5 ("pq") over a (nq, n)
    distance matrix: blocks of qb queries x chunks of chunk_rows rows
    walked in the kernel's tiles (masked rows and sentinel distances never
    offered, nor, with `floor` (nq,) keys, the keys up to the query's
    floor), each chunk's partial the first kp keys of its states; then
    the per-query merge.  -> (dists, ids, the blocks' segments)."""
    tile, warps, is_float = TILE[kind], WARPS[kind], kind == "pq"
    nq, n = d_full.shape
    kp = min(kp, n)
    ids = torch.arange(n, dtype=torch.int64)
    parts = [[] for _ in range(nq)]
    segments = []
    for q0 in range(0, nq, qb):
        qs = range(q0, min(nq, q0 + qb))
        for r0 in range(0, n, chunk_rows):
            r1 = min(n, r0 + chunk_rows)
            tiles = []
            for t0 in range(r0, r1, tile):
                t1 = min(r1, t0 + tile)
                keep = ok[t0:t1] != 0
                keys = [_keys(d_full[q, t0:t1][keep & (d_full[q, t0:t1]
                                                       < big)],
                              ids[t0:t1][keep & (d_full[q, t0:t1] < big)],
                              is_float) for q in qs]
                if floor is not None:
                    keys = [k[k > floor[q]] for k, q in zip(keys, qs)]
                tiles.append(keys)
            segs = _scan_block(tiles, kp, warps)
            segments += segs
            for q, s in zip(qs, segs):
                parts[q].append(s.state[:kp])
    dists, out_i = [], []
    for q in range(nq):
        d, i = _unkey(_merge_runs(torch.stack(parts[q]), kp), is_float)
        dists.append(d)
        out_i.append(i)
    return torch.stack(dists), torch.stack(out_i), segments


def _sq_dists_by_slices(q8, c8, cn, ks=SQ_KS):
    """K4's arithmetic: depth cut into ks-byte slices zero-padded past d
    (SQ_KS on the staging route, SQ_SLICE on the TMA route), int8
    products summed in int32 slice by slice (exact in any order), then
    cn - 2 cross in int32."""
    nq, d = q8.shape
    pad = -(-d // ks) * ks
    qz = np.zeros((nq, pad), np.int64)
    cz = np.zeros((c8.shape[0], pad), np.int64)
    qz[:, :d], cz[:, :d] = q8, c8
    cross = np.zeros((nq, c8.shape[0]), np.int64)
    for k0 in range(0, pad, ks):
        cross += qz[:, k0:k0 + ks] @ cz[:, k0:k0 + ks].T
        assert np.abs(cross).max() < 2 ** 31           # int32 accumulators
    return (cn.astype(np.int64)[None, :] - 2 * cross).astype(np.int32)


def _pq_dists_interleaved(lut, codes_t, qb):
    """K5's arithmetic: each block's tables laid out as in shared memory,
    entry (j, code) of query q at float (j * 256 + code) * qb + q, and
    each sum taken over j ascending, one float32 add at a time."""
    nq, m, _ = lut.shape
    T = m * 256
    out = []
    for q0 in range(0, nq, qb):
        tab = np.zeros(T * qb, np.float32)
        for q in range(min(qb, nq - q0)):
            tab[np.arange(T) * qb + q] = lut[q0 + q].ravel()
        acc = np.zeros((min(qb, nq - q0), codes_t.shape[1]), np.float32)
        for j in range(m):
            for q in range(acc.shape[0]):
                acc[q] = acc[q] + tab[(j * 256 + codes_t[j].astype(np.int64))
                                      * qb + q]
        out.append(acc)
    return np.concatenate(out)


def _pq_queries_per_block(kp, m):
    """_plan's choice for K5: the largest of 8, 4, 2, 1 that fits."""
    return next(qb for qb in adc_topk._PQ_QUERIES_PER_BLOCK
                if _smem("pq", qb, kp, m) <= SHARED_LIMIT)


@pytest.mark.parametrize("nq,n,d,kp,valid,dup,chunk_rows", [
    (3, 5000, 16, 160, 0.99, 500, 1024),
    (2, 700, 17, 300, 1.0, 0, 256),      # kp > chunk: partials hold EMPTY
    (2, 100, 16, 30, 0.12, 0, 256),      # exhaustion
    (2, 3000, 960, 64, 1.0, 300, 2048),
    (33, 2000, 40, 50, 0.95, 200, 512),  # a second query group of one
    (3, 2600, 24, 1024, 1.0, 0, 1024),   # kp 1024: 16 queries a block
])
def test_sq_kernel_blocking_emulated_equals_oracle(nq, n, d, kp, valid, dup,
                                                   chunk_rows):
    """Each shape on the route the wrapper picks for it (the TMA route's
    128-byte depth slices where d % 16 == 0 and a ring fits, else the
    staging route's 64-byte slices)."""
    q8, c8, cn = _sq_case(nq, n, d, seed=n, dup=dup, far=d == 960)
    ok = np.random.default_rng(n).random(n) < valid
    route = _route(n, d, min(kp, n))
    full = _sq_dists_by_slices(q8, c8, cn,
                               SQ_SLICE if route.tma else SQ_KS)
    np.testing.assert_array_equal(full, j_adc_ref.sq_dists(q8, c8, cn))
    qb = adc_topk.sq_queries_per_block(min(kp, n))
    got_d, got_i, segs = _emulate(_t(full), _t(ok), kp, qb, chunk_rows,
                                  "sq", INT_BIG)
    want_d, want_i = _oracle(full, ok, kp, INT_BIG)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    assert _smem("sq", qb, kp, d) <= SHARED_LIMIT
    if route.tma:
        assert _tma_smem(qb, min(kp, n), d, route.qreg, route.stages) <= \
            SHARED_LIMIT
    assert all(s.buf.numel() == 0 for s in segs)


@pytest.mark.parametrize("nq,n,m,kp,valid,dup,chunk_rows", [
    (3, 5000, 16, 320, 0.99, 500, 1024),
    (2, 100, 16, 30, 0.12, 0, 1024),
    (2, 3000, 2, 64, 1.0, 0, 1024),      # two subspaces: many equal sums
    (33, 3000, 8, 40, 0.97, 200, 2048),  # a second query group of one
    (5, 2500, 32, 100, 1.0, 0, 1024),    # m 32: 4 queries a block
    (3, 1500, 64, 1024, 0.9, 100, 1024),  # m 64, kp 1024: 2 a block
])
def test_pq_kernel_blocking_emulated_equals_oracle(nq, n, m, kp, valid, dup,
                                                   chunk_rows):
    lut, codes_t = _pq_case(nq, n, m, seed=n, dup=dup)
    ok = np.random.default_rng(n).random(n) < valid
    qb = _pq_queries_per_block(min(kp, n), m)
    full = _pq_dists_interleaved(lut, codes_t, qb)
    _same(full, j_adc_ref.pq_dists(lut, codes_t))
    got_d, got_i, segs = _emulate(_t(full), _t(ok), kp, qb, chunk_rows,
                                  "pq", float("inf"))
    want_d, want_i = _oracle(full, ok, kp, np.float32(np.inf))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    _same(got_d.numpy(), want_d)
    assert all(s.buf.numel() == 0 for s in segs)


def _last_keys(d, ids, is_float):
    """What a pass's merge leaves in floor_out: each query's last key,
    EMPTY where its valid rows ran out."""
    return torch.where(ids[:, -1] < 0, EMPTY,
                       _keys(d[:, -1], ids[:, -1].clamp(min=0), is_float))


@pytest.mark.parametrize("kind,nq,n,width,valid", [
    ("sq", 3, 2500, 16, 1.0),
    ("sq", 2, 2000, 17, 0.6),        # 1200 valid rows: pass 2 runs out
    ("pq", 3, 2500, 8, 1.0),
    ("pq", 2, 3000, 4, 0.2),         # 600 valid: pass 1 runs out, stop
])
def test_adc_floor_passes_emulated_equal_oracle(kind, nq, n, width, valid):
    """kp 1600 > MAX_KP: `common.floor_passes` over the emulated kernel,
    each pass offering only the keys after its query's floor key, equals
    the oracle's first 1600 slots, exhausted slots included."""
    kp = 1600
    is_float = kind == "pq"
    ok = np.random.default_rng(n).random(n) < valid
    if is_float:
        lut, codes_t = _pq_case(nq, n, width, seed=n, dup=300)
        full, big = j_adc_ref.pq_dists(lut, codes_t), float("inf")
    else:
        q8, c8, cn = _sq_case(nq, n, width, seed=n, dup=300)
        full, big = j_adc_ref.sq_dists(q8, c8, cn), INT_BIG
    full = np.asarray(full)
    sizes, calls = common.pass_sizes(kp, adc_topk.MAX_KP), []

    def one_pass(p, floor_in, floor_out):
        calls.append(p)
        qb = (_pq_queries_per_block(p, width) if is_float
              else adc_topk.sq_queries_per_block(p))
        d, i, _ = _emulate(_t(full), _t(ok), p, qb, 1024, kind, big,
                           floor=floor_in)
        floor_out.copy_(_last_keys(d, i, is_float))
        return d, i

    got_d, got_i = common.floor_passes(kp, adc_topk.MAX_KP, nq, one_pass,
                                       big, "cpu")
    want_d, want_i = _oracle(full, ok, kp, big)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    assert sizes == [800, 800]
    assert calls == (sizes[:1] if ok.sum() < sizes[0] else sizes)


def _refill_case(kind, n):
    """Query 0: distances that make a buffer overflow inside a tile.  PQ
    (tiles of 1024 rows, buffers of 256): descending, so every row beats
    the ones before it.  int8 (tiles of 256 rows, as long as a buffer):
    per tile, 2 / 5 of the rows beat everything before them and the rest
    lose, so a buffer holding one tile's keys overflows on the next.
    Query 1 ascending (few offers), query 2 random."""
    if kind == "pq":
        d0 = torch.arange(n, 0, -1, dtype=torch.float32)
    else:
        d0 = torch.empty(n, dtype=torch.int32)
        for t0 in range(0, n, TILE["sq"]):
            rows = torch.arange(t0, min(n, t0 + TILE["sq"]))
            win = rows % 5 < 2
            d0[rows] = torch.where(win, 10 ** 6 - rows,
                                   10 ** 7 + rows).to(torch.int32)
    rand = torch.as_tensor(np.random.default_rng(n).permutation(n))
    return torch.stack([d0, torch.sort(d0).values, d0[rand]])


@pytest.mark.parametrize("kind,n,kp", [("sq", 3000, 160), ("sq", 2000, 30),
                                       ("pq", 5000, 320), ("pq", 3000, 1)])
def test_adc_selection_refills_a_full_buffer_within_a_tile(kind, n, kp):
    """A buffer fills in the middle of a tile: the keys left over stay
    with their threads, are offered again after the merge, and the result
    is still the exact top-kp."""
    is_float = kind == "pq"
    d = _refill_case(kind, n)
    ok = torch.ones(n, dtype=torch.bool)
    big = float("inf") if is_float else INT_BIG
    got_d, got_i, segs = _emulate(d, ok, kp, 2, 4 * TILE[kind], kind, big)
    want = torch.sort(d, dim=1, stable=True)
    np.testing.assert_array_equal(got_i.numpy(), want.indices[:, :kp])
    np.testing.assert_array_equal(got_d.numpy(), want.values[:, :kp])
    assert segs[0].refused > 0 and segs[0].merges > n // (4 * TILE[kind])


SMS = 132                      # H100 SXM: the block plans' SMs


def _old_plan(groups, n, tile, sms):
    """The rule the fused scans had before the block plan: one block per
    SM over ceil(SMs / groups) chunks.  -> (tiles a chunk, G)."""
    tiles = -(-n // tile)
    G = min(tiles, max(1, -(-sms // groups)))
    per = -(-tiles // G)
    return per, -(-tiles // per)


def _makespan(groups, per, G, slots, c):
    """A plan's waves x (tiles a chunk + c), in tile-times."""
    return -(-groups * G // slots) * (per + c)


def _sweep_plans(tile, qb_of, c, resident):
    """Every plan of nq 1-4096 x kp {10, 80, 160, 800, 1024} x n {10^5,
    2^18, 10^6, 2^24} (one a distinct query-group count), against the old
    rule at the same slots: valid chunks, a makespan never longer, one
    wave wherever the groups divide the slots, and the old plan itself
    at nq <= 32."""
    slots = SMS * resident
    seen = set()
    for kp in (10, 80, 160, 800, 1024):
        qb = qb_of(kp)
        for n in (10 ** 5, 2 ** 18, 10 ** 6, 2 ** 24):
            for nq in range(1, 4097):
                groups = -(-nq // qb)
                if (groups, n, qb) in seen:
                    continue
                seen.add((groups, n, qb))
                plan = common.block_plan(groups, n, tile, slots, c)
                tiles = -(-n // tile)
                per = plan.chunk_rows // tile
                assert plan.chunk_rows % tile == 0
                assert (plan.G - 1) * plan.chunk_rows < n <= \
                    plan.G * plan.chunk_rows
                old = _old_plan(groups, n, tile, SMS)
                assert _makespan(groups, per, plan.G, slots, c) <= \
                    _makespan(groups, *old, slots, c)
                if slots % groups == 0:
                    assert plan.G * groups <= slots, (nq, n, kp)
                if nq <= 32 and resident == 1:
                    assert (per, plan.G) == old, (nq, n, kp)
                waves = -(-groups * plan.G // slots)
                assert plan.work_tiles == groups * tiles
                assert plan.slot_tiles == slots * waves * per


def _clear_plans():
    adc_topk._layout.cache_clear()
    adc_topk._sq_layout.cache_clear()


def _mock_adc_entries(monkeypatch, resident=1):
    """The C entries _plan calls, answered as csrc/adc_topk.cu would; the
    occupancy entry answers `resident` and records its arguments."""
    asked = []

    class Props:
        multi_processor_count = 132
        shared_memory_per_block_optin = SHARED_LIMIT

    def function(name, argtypes):
        if name == "repro_adc_blocks_per_sm":
            assert len(argtypes) == 8
            return lambda *a: asked.append(a) or resident
        if name == "repro_sq_tma_smem_bytes":
            assert len(argtypes) == 5
            return _tma_smem
        assert name == "repro_adc_smem_bytes" and len(argtypes) == 4
        return lambda pq, qb, kp, width: _smem("pq" if pq else "sq", qb, kp,
                                               width)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    _clear_plans()
    return asked


@pytest.fixture
def adc_entries(monkeypatch):
    yield lambda resident=1: _mock_adc_entries(monkeypatch, resident)
    _clear_plans()


def test_plan_mirrors_the_kernels(adc_entries):
    """_plan's queries a block (K4: 32, or 16 past kp 256; K5: the largest
    of 8, 4, 2, 1 whose tables fit), its refusal, and chunks of whole
    tiles: the block plan over 132 SMs at the one block an SM that the
    occupancy entry answers, asked for the launched variant (K4 or K5,
    queries a block, kp, width, later pass; K4's TMA route also its
    queries in registers and ring stages, 0 0 on the staging route).
    The int8 cell's shape (nq 1024, kp 160) takes one wave of 32 x 4
    blocks, 977 tiles each, where the old rule took 32 x 5 in two
    waves."""
    asked = adc_entries()
    assert adc_topk._plan("sq", 128, 32, 10 ** 6, 160, None) == (32, 7680,
                                                                  131)
    assert adc_topk._plan("sq", 960, 33, 2 ** 18, 320, None)[0] == 16
    assert adc_topk._plan("sq", 2048, 32, 2 ** 18, 1024, None)[0] == 16
    assert adc_topk._plan("pq", 16, 32, 10 ** 6, 320, None) == (8, 30720, 33)
    for m, qb in ((8, 8), (16, 8), (32, 4), (64, 2), (200, 1)):
        assert adc_topk._plan("pq", m, 32, 5000, 1024, None)[0] == qb
        assert _pq_queries_per_block(1024, m) == qb
    with pytest.raises(ValueError, match="shared memory"):
        adc_topk._plan("pq", 256, 2, 2000, 1024, None)
    with pytest.raises(ValueError, match="limit"):
        adc_topk._plan("sq", 16, 2, 2000, adc_topk.MAX_KP + 1, None)
    for kind, width in (("sq", 17), ("pq", 3)):
        for nq, n, kp in ((1, 1, 1), (33, 70001, 300), (5, 1023, 40)):
            qb, chunk, G = adc_topk._plan(kind, width, nq, n, kp, None)
            assert chunk % TILE[kind] == 0 and (G - 1) * chunk < n <= G * chunk
            assert G * -(-nq // qb) <= 132 or chunk == TILE[kind]
    assert adc_topk._plan("sq", 128, 1024, 10 ** 6, 160, None) == (
        32, 977 * 256, 4)
    assert _old_plan(32, 10 ** 6, 256, 132) == (782, 5)
    assert adc_topk._plan("pq", 16, 1024, 10 ** 6, 320, None)[0] == 8
    _clear_plans()
    del asked[:]
    adc_topk._plan("sq", 128, 1024, 10 ** 6, 160, None)
    adc_topk._plan("sq", 128, 1024, 10 ** 6, 160, None)
    adc_topk._plan("sq", 128, 20, 5000, 600, None, True)
    adc_topk._plan("sq", 17, 20, 5000, 600, None, True)
    adc_topk._plan("pq", 16, 32, 10 ** 6, 320, None)
    assert asked == [(0, 32, 160, 128, 0, 1, 3, 0),
                     (0, 16, 600, 128, 1, 1, 2, 0),
                     (0, 16, 600, 17, 1, 0, 0, 0),
                     (1, 8, 320, 16, 0, 0, 0, 0)]
    qb, plan = adc_topk._layout("sq", 128, 1024, 10 ** 6, 160, None)
    assert (plan.work_tiles, plan.slot_tiles) == (32 * 3907, 132 * 977)


def test_plan_counts_resident_blocks(adc_entries):
    """Two blocks an SM give 264 slots: the int8 cell's shape then takes
    one wave of 32 x 8 blocks; no block on an SM is refused."""
    adc_entries(resident=2)
    assert adc_topk._plan("sq", 128, 1024, 10 ** 6, 160, None)[2] == 8
    adc_entries(resident=0)
    with pytest.raises(RuntimeError, match="no block fits"):
        adc_topk._plan("sq", 128, 1024, 10 ** 6, 160, None)


@pytest.mark.parametrize("resident", [1, 2])
def test_adc_block_plans_over_a_sweep_of_shapes(resident):
    """K4's plans (tiles of 256, 32 queries a block or 16 past kp 256)
    and K5's at 8 queries a block (tiles of 1024) over the sweep of
    `_sweep_plans`: never a longer makespan than the old rule, one wave
    where the groups divide the slots, the old plans at nq <= 32."""
    _sweep_plans(TILE["sq"], adc_topk.sq_queries_per_block,
                 adc_topk._CHUNK_COST["sq"], resident)
    _sweep_plans(TILE["pq"], lambda kp: 8, adc_topk._CHUNK_COST["pq"],
                 resident)


def test_pq_plans_at_nq_32_where_groups_divide_the_slots(adc_entries):
    """K5 at nq 32 keeps the old plan where its query groups divide the
    132 SMs (8, 4 or 2 queries a block: 4, 8... groups -- m 16's 33
    chunks), and takes no second wave the old rule took at 32 groups of
    one query (m 200): 4 chunks of 32 blocks, not 5."""
    adc_entries()
    for m, groups in ((16, 4), (64, 16), (200, 32)):
        qb, chunk, G = adc_topk._plan("pq", m, 32, 10 ** 6, 20, None)
        assert 32 // qb == groups
        per = chunk // TILE["pq"]
        if 132 % groups == 0:
            assert (per, G) == _old_plan(groups, 10 ** 6, TILE["pq"], 132)
        assert G * groups <= 132
    assert _old_plan(32, 10 ** 6, TILE["pq"], 132)[1] * 32 > 132


def test_sq_route_follows_the_shape():
    """K4's route from d, kp and the codes' alignment: the TMA route where
    d % 16 == 0, the codes are 16-byte aligned and a ring of 4, 3 or 2
    stages fits beside the selection (the most that fit), with the query
    fragments in registers where they take at most 32 a lane (d <= 128 at
    32 queries a block, d <= 256 at 16), else in shared memory; byte
    staging otherwise."""
    R = adc_topk.SqRoute
    n = 10 ** 6
    assert _route(n, 128, 160) == R(True, True, 3)           # int8 cell
    assert _route(n, 960, 160) == R(True, False, 2)          # GIST width
    assert _route(n, 256, 300) == R(True, True, 4)           # 16 a block
    assert _route(n, 384, 300) == R(True, False, 3)
    assert _route(n, 128, 800) == R(True, True, 2)           # k' 1600
    assert _route(n, 16, 30) == R(True, True, 3)
    assert _route(257, 128, 30) == R(True, True, 3)
    assert _route(256, 128, 30) == R(False, False, 0)        # one tile
    assert _route(100, 128, 30) == R(False, False, 0)
    assert _route(n, 100, 160) == R(False, False, 0)         # d % 16
    assert _route(n, 17, 30) == R(False, False, 0)
    assert _route(n, 128, 160, aligned=False) == R(False, False, 0)
    assert _route(n, 960, 1024) == R(False, False, 0)        # no ring fits
    assert _route(n, 2048, 160) == R(False, False, 0)
    for d in (16, 128, 256, 960):
        for kp in (1, 160, 256, 300, 512, 600, 1024):
            route = _route(n, d, kp)
            qb = adc_topk.sq_queries_per_block(kp)
            assert route.qreg == (route.tma and (qb // 16) * -(-d // 128)
                                  * 16 <= 32)
            if route.tma:
                assert _tma_smem(qb, kp, d, route.qreg, route.stages) <= \
                    SHARED_LIMIT
                assert route.stages == 4 or _tma_smem(
                    qb, kp, d, route.qreg, route.stages + 1) > SHARED_LIMIT


def test_sq_plan_follows_the_route(adc_entries):
    """K4's plan in the wrapper: over 132 SMs x the blocks of the route's
    variant one SM holds, at the route's own chunk cost (74 tile-times on
    the TMA route, 30 on the staging route).  The int8 cell's shape takes
    the TMA route and one wave of 32 x 4 blocks; a misaligned or d % 16
    != 0 shape the staging route; no block on an SM is refused."""
    asked = adc_entries()
    n = 10 ** 6
    qb, plan, route = adc_topk._sq_layout(128, 1024, n, 160, None)
    assert (qb, plan.G, route) == (32, 4, adc_topk.SqRoute(True, True, 3))
    assert plan == common.block_plan(32, n, 256, 132,
                                     adc_topk._CHUNK_COST["sq_tma"])
    assert adc_topk._sq_layout(17, 1024, n, 160, None)[2] == \
        adc_topk.SqRoute(False, False, 0)
    assert adc_topk._sq_layout(128, 1024, n, 160, None, False,
                               False)[2].tma is False
    assert adc_topk._sq_layout(100, 1024, n, 160, None)[1] == \
        common.block_plan(32, n, 256, 132, adc_topk._CHUNK_COST["sq"])
    assert asked == [(0, 32, 160, 128, 0, 1, 3, 0),
                     (0, 32, 160, 17, 0, 0, 0, 0),
                     (0, 32, 160, 128, 0, 0, 0, 0),
                     (0, 32, 160, 100, 0, 0, 0, 0)]
    adc_entries(resident=0)
    with pytest.raises(RuntimeError, match="no block fits"):
        adc_topk._sq_layout(128, 1024, n, 160, None)


@pytest.mark.parametrize("nq", [32, 1024, 4096])
def test_sq_staging_plans_keep_their_chunk_cost(adc_entries, nq):
    """The byte-staging route (d 100, as GloVe's; or misaligned codes)
    plans at its own chunk cost of 30 tile-times, as before the TMA
    route, and the TMA route at 74; both over the same slots."""
    adc_entries()
    n = 10 ** 6
    for d, aligned in ((100, True), (128, False)):
        plan = adc_topk._sq_layout(d, nq, n, 160, None, False, aligned)[1]
        assert plan == common.block_plan(-(-nq // 32), n, 256, 132, 30.0)
    plan = adc_topk._sq_layout(128, nq, n, 160, None)[1]
    assert plan == common.block_plan(-(-nq // 32), n, 256, 132, 74.0)


@pytest.mark.parametrize("nq,qb", [(65, 32), (70, 32), (33, 16), (5, 32)])
def test_sq_tma_blocking_emulated_with_a_ragged_last_group(nq, qb):
    """The TMA route's 128-byte depth slices with a last query group that
    holds fewer than qb queries (its rows past nq zero): the result equals
    the oracle and every query has a segment a chunk."""
    n, d, kp = 3000, 128, 160 if qb == 32 else 300
    q8, c8, cn = _sq_case(nq, n, d, seed=nq, dup=300)
    ok = np.random.default_rng(nq).random(n) < 0.99
    full = _sq_dists_by_slices(q8, c8, cn, SQ_SLICE)
    assert _route(n, d, kp).tma
    got_d, got_i, segs = _emulate(_t(full), _t(ok), kp, qb, 1024, "sq",
                                  INT_BIG)
    want_d, want_i = _oracle(full, ok, kp, INT_BIG)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    assert len(segs) == nq * 3                         # 3 chunks of 1024
    assert nq % qb != 0


def test_k1_and_k5_plans_unchanged_at_the_cells_shapes():
    """K4's TMA route leaves `common.block_plan` and the K1 / K5 plans
    as they were: at a batch of 1024 over 1M rows on 132 SMs, K1 at k' 80
    (the flat and GIST k10 cells) one wave of 32 x 4 blocks, at k' 800 (8
    queries a block) 128 x 1; K5 at m 16, kp 320 (8 a block) 128 x 1."""
    from repro_torch.kernels.l2_topk import l2_topk
    assert l2_topk._chunks(1024, 10 ** 6, 32, 132)[:2] == (489 * 512, 4)
    assert l2_topk._chunks(1024, 10 ** 6, 8, 132)[:2] == (1954 * 512, 1)
    assert common.block_plan(128, 10 ** 6, TILE["pq"], 132,
                             adc_topk._CHUNK_COST["pq"])[:2] == (977 * 1024,
                                                                 1)
    assert common.block_plan(32, 10 ** 6, TILE["sq"], 132,
                             adc_topk._CHUNK_COST["sq"])[:2] == (977 * 256, 4)


@pytest.mark.parametrize("G", [1, 4, 5, 33])
def test_sq_blocking_emulated_is_the_same_at_any_G(G):
    """Chunks of whole 256-row tiles: K4's emulated scan + merge gives the
    same ids and distances at G 1, 4, 5 and 33 (ties, masked rows),
    equal to the oracle."""
    nq, d, kp, tiles = 33, 16, 160, 66
    n = tiles * TILE["sq"] - 50
    q8, c8, cn = _sq_case(nq, n, d, seed=G, dup=500)
    ok = np.random.default_rng(1).random(n) < 0.98
    full = _sq_dists_by_slices(q8, c8, cn)
    chunk_rows = -(-tiles // G) * TILE["sq"]
    assert -(-n // chunk_rows) == G
    got_d, got_i, _ = _emulate(_t(full), _t(ok), kp, 32, chunk_rows, "sq",
                               INT_BIG)
    want_d, want_i = _oracle(full, ok, kp, INT_BIG)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)


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


@pytest.fixture(scope="module")
def corpus_2k():
    ds = synth.make_dataset("deep1m", n=2000, n_queries=4, k_gt=30, seed=22,
                            d=32)
    beta = jdcpe.suggest_beta(ds.base, fraction=0.03)
    owner = ppanns.DataOwner(d=ds.d, sap_beta=beta, seed=22)
    db = owner.encrypt_database(ds.base, build_index=False)
    user = ppanns.User(owner.share_keys())
    qs, ts = zip(*(user.encrypt_query(q) for q in ds.queries))
    return ds, db, np.stack(qs), np.stack(ts)


@pytest.mark.parametrize("kw,k", [({}, 200),
                                  (dict(quantization="int8"), 100),
                                  (dict(quantization="pq8"), 50)],
                         ids=["flat-k200", "int8-k100", "pq8-k50"])
def test_engine_at_k_prime_1600_equals_jax(corpus_2k, kw, k):
    """ratio_k 8 at these k gives 1600 candidates (k' 1600 flat; 800 x 2
    and 400 x 4 oversampled for int8 and pq8), above the fused kernels'
    1024 a pass: the port's engine returns the JAX engine's ids and
    SearchStats."""
    ds, db, Q, T = corpus_2k
    jeng = jse.SecureSearchEngine(db.C_sap, db.C_dce, backend="flat", **kw)
    teng = se.SecureSearchEngine(db.C_sap, db.C_dce, backend="flat",
                                 device=CPU, **kw)
    want, wst = jeng.search_batch(Q, T, k, ratio_k=8)
    got, gst = teng.search_batch(Q, T, k, ratio_k=8)
    np.testing.assert_array_equal(got, want)
    for f in COUNTS:
        assert getattr(gst, f) == getattr(wst, f), f
    assert gst.refine_comparisons == Q.shape[0] * 1600 * 1599


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
