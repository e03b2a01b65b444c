"""16-bit operands: every kernel entry of the port against the JAX
package's, on the CPU.

The reference's Pallas kernels cast any float operand to float32 before
they compute (K4 casts `cn` to int32, K5 its tables to float32); the
port's kernels read bf16 and f16 rows in place and compute in float32
too.  The same values cross between the packages as their uint16 bit
patterns, so both see identical bf16 / f16 operands.  On the CPU each
wrapper runs its plain version; the JAX side runs its Pallas kernel in
interpret mode (as tests/test_kernels.py does), its numpy `ref.py`
(K4, K5), or, where the reference's kernel cannot run here (K6, its
`graph_expand` kernel; tests/test_graph.py), its XLA walk on the float32
upcast, which is what that kernel computes.

Tolerances: ids slot for slot, win counts, beams, visited traces, hops
and edges exactly equal; l2 distances within 1e-5 of ||q||^2 + ||x||^2,
Z within 1e-5 * max|Z| and walk distances within rtol 1e-6 (fp32 sums
taken in another order); K5's sums bit-equal (one order).  The secure-
scan step: the port's bf16 step against the reference's on the float32
upcast (ids as sets, as tests/test_secure_scan.py compares its two
steps), and within an overlap of 0.95 of the reference's all-bf16 step,
whose XLA filter and refine compute in bf16 (a divergence the port
does not copy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dce as jdce
from repro.core import dcpe as jdcpe
from repro.core import ppanns as jppanns
from repro.data import synth as jsynth
from repro.graph import traverse as jtraverse
from repro.kernels.adc_topk import ref as j_adc_ref
from repro.kernels.dce_comp import dce_comp as j_dce
from repro.kernels.dce_comp import ops as j_dce_ops
from repro.kernels.l2_topk import l2_topk as j_l2
from repro.kernels.l2_topk import ops as j_l2_ops
from repro.launch.mesh import make_mesh
from repro.serving import secure_scan as jscan
from repro_torch.kernels import _build
from repro_torch.kernels.adc_topk import adc_topk
from repro_torch.kernels.adc_topk import ops as adc_ops
from repro_torch.kernels.dce_comp import dce_comp
from repro_torch.kernels.graph_expand import graph_expand
from repro_torch.kernels.l2_topk import l2_topk
from repro_torch.kernels.l2_topk import ops as l2_ops
from repro_torch.launch.mesh import force_device_count, local_devices
from repro_torch.serving import secure_scan

HALVES = ["bfloat16", "float16"]
L2_RTOL = 1e-5
Z_RTOL = 1e-5
WALK_RTOL = 1e-6


@pytest.fixture(autouse=True)
def no_kernel_launch(monkeypatch):
    """On the CPU and on `meta` tensors no wrapper may reach the build or
    launch path."""
    def refuse(*a, **kw):
        raise AssertionError("a host or meta tensor reached the launch path")
    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def _bits(x: np.ndarray, dtype: str) -> np.ndarray:
    """x rounded to `dtype` (to nearest even), as uint16 bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(getattr(torch, dtype)).view(torch.int16).numpy().view(
        np.uint16)


def _tq(bits: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16)).view(getattr(torch, dtype))


def _jx(bits: np.ndarray, dtype: str):
    return jax.lax.bitcast_convert_type(jnp.asarray(bits),
                                        getattr(jnp, dtype))


def _f32(bits: np.ndarray, dtype: str) -> np.ndarray:
    """The float32 upcast of the 16-bit values (exact)."""
    return _tq(bits, dtype).float().numpy()


def _launches() -> dict:
    return {**l2_topk.launches, **dce_comp.launches,
            **graph_expand.launches, **adc_topk.launches}


# -------------------------------------------------------------------- K1

@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("nq,n,d,k", [(6, 2000, 48, 40), (3, 700, 13, 9)])
def test_l2_entries_on_16bit_rows_equal_the_reference(dtype, nq, n, d, k):
    rng = np.random.default_rng(n + d)
    X = _bits(rng.standard_normal((n, d)), dtype)
    Q = _bits(rng.standard_normal((nq, d)), dtype)
    jd, ji = j_l2_ops.knn(_jx(Q, dtype), _jx(X, dtype), k, chunk=512,
                          interpret=True)
    td, ti = l2_ops.knn(_tq(Q, dtype), _tq(X, dtype), k, chunk=512)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    Xf, Qf = _f32(X, dtype), _f32(Q, dtype)
    scale = (Qf * Qf).sum(1)[:, None] + (Xf * Xf).sum(1).max()
    assert np.all(np.abs(td.numpy() - np.asarray(jd)) <= L2_RTOL * scale)
    jt = np.asarray(j_l2.pairwise_sq_dists(_jx(Q, dtype), _jx(X, dtype),
                                           interpret=True))
    tt = l2_topk.pairwise_sq_dists(_tq(Q, dtype), _tq(X, dtype)).numpy()
    assert tt.dtype == np.float32
    bound = (Qf * Qf).sum(1)[:, None] + (Xf * Xf).sum(1)[None, :]
    assert np.all(np.abs(tt - jt) <= L2_RTOL * bound)


# ----------------------------------------------------------------- K2, K3

def _dce_case(B, n, d, dtype, seed, invalid=0.1):
    rng = np.random.default_rng(seed)
    key = jdce.keygen(d, seed=seed)
    C = jdce.encrypt(rng.standard_normal((B * n, d)), key, seed=seed + 1)
    T = jdce.trapgen(rng.standard_normal((B, d)), key, seed=seed + 2)
    cand = rng.permuted(np.arange(B * n).reshape(B, n), axis=1)
    valid = rng.random((B, n)) >= invalid
    return (_bits(np.asarray(C), dtype), cand,
            _bits(np.asarray(T), dtype), valid)


@pytest.mark.parametrize("dtype", HALVES)
def test_dce_entries_on_16bit_ciphertexts_equal_the_reference(dtype):
    """batched_z_matrix, z_matrix (Pallas in interpret mode) and the
    fused refine's win counts and ids (the reference's
    batched_top_k_by_wins on the gathered candidates)."""
    B, n, d, k = 3, 40, 16, 7
    C, cand, T, valid = _dce_case(B, n, d, dtype, seed=5)
    Cc = C[cand]                                  # (B, n, 4, D)
    jZ = np.asarray(j_dce.batched_z_matrix(_jx(Cc, dtype), _jx(T, dtype),
                                           interpret=True))
    tZ = dce_comp.batched_z_matrix(_tq(Cc, dtype), _tq(T, dtype)).numpy()
    assert tZ.dtype == np.float32
    tol = Z_RTOL * np.abs(jZ).max()
    assert np.all(np.abs(tZ - jZ) <= tol)
    jz = np.asarray(j_dce.z_matrix(_jx(Cc[1], dtype), _jx(T[1], dtype),
                                   interpret=True))
    tz = dce_comp.z_matrix(_tq(Cc[1], dtype), _tq(T[1], dtype)).numpy()
    assert np.all(np.abs(tz - jz) <= tol)

    ids, wins = dce_comp.refine_topk(_tq(C, dtype), torch.from_numpy(cand),
                                     _tq(T, dtype), torch.from_numpy(valid),
                                     k, return_wins=True)
    offdiag = ~np.eye(n, dtype=bool)[None]
    want_wins = ((jZ < 0) & offdiag & valid[:, None, :]).sum(-1)
    want_wins = np.where(valid, want_wins, -1)
    np.testing.assert_array_equal(wins.numpy(), want_wins)
    local = np.asarray(j_dce_ops.batched_top_k_by_wins(
        _jx(Cc, dtype), _jx(T, dtype), k, valid=jnp.asarray(valid),
        interpret=True))
    want = np.take_along_axis(cand, local, 1)
    want = np.where(np.take_along_axis(valid, local, 1), want, -1)
    np.testing.assert_array_equal(ids.numpy(), want)


# -------------------------------------------------------------------- K6

def _walk_case(dtype, seed, R=512, M0=8, M=4, LU=4, d=24, nq=5):
    """A random graph with upper layers (the top one an empty padded
    layer) over random rows rounded to `dtype`."""
    rng = np.random.default_rng(seed)
    C = _bits(rng.standard_normal((R, d)), dtype)
    Q = _bits(rng.standard_normal((nq, d)), dtype)
    neigh0 = rng.integers(0, R, size=(R, M0)).astype(np.int32)
    neigh0[rng.random((R, M0)) < 0.1] = -1
    ok = rng.random(R) > 0.03
    up = np.full((LU, R, M), -1, np.int32)
    for li in range(LU - 1):
        nodes = rng.choice(R, size=R // (4 << li), replace=False)
        rows = rng.choice(nodes, size=(len(nodes), M)).astype(np.int32)
        rows[rng.random(rows.shape) < 0.2] = -1
        up[li, nodes] = rows
    entry = int(np.flatnonzero(ok & (up[0, :, 0] >= 0))[0])
    return neigh0, up, ok, C, Q, entry


def _walks_equal(got, want):
    """(beam ids, distances, visited, hops, edges) of the port against the
    reference's (ids (nq, kp) of the same beam)."""
    gi, gd, gv, gh, ge = (t.numpy() for t in got)
    wi, wd, wv, wh, we = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=WALK_RTOL)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gh, wh)
    np.testing.assert_array_equal(ge, we)


@pytest.mark.parametrize("dtype", HALVES)
def test_graph_walk_on_16bit_rows_equals_the_reference(dtype):
    """graph_walk on bf16 / f16 rows and queries against the reference's
    walk on their float32 upcast (its Pallas kernel casts to float32;
    its XLA scorer would compute in the operand dtype)."""
    neigh0, up, ok, C, Q, entry = _walk_case(dtype, seed=7)
    ef, ef_cap = 24, 32
    kw = dict(ef_cap=ef_cap, max_hops=4 * ef_cap)
    got = graph_expand.graph_walk(
        torch.from_numpy(neigh0), torch.from_numpy(up), torch.from_numpy(ok),
        _tq(C, dtype), _tq(Q, dtype), entry, ef, **kw)
    want = jtraverse.traverse(
        jnp.asarray(neigh0), jnp.asarray(up), jnp.asarray(ok),
        (jnp.asarray(_f32(C, dtype)),), jnp.asarray(_f32(Q, dtype)),
        jnp.int32(entry), jnp.int32(ef), kp=ef_cap, **kw)
    _walks_equal(got, want)
    assert int(got[3].min()) > 1


@pytest.mark.parametrize("dtype", HALVES)
def test_plain_layer0_scores_16bit_rows_in_float32(dtype):
    """The plain K6 scorer upcasts 16-bit rows and queries before it
    subtracts and squares (the reference's expand_layer0 casts both to
    float32): expand_layer0 on bf16 / f16 operands equals the reference's
    layer 0 on the float32 upcast, distances included."""
    neigh0, _, ok, C, Q, _ = _walk_case(dtype, seed=8, LU=2)
    rng = np.random.default_rng(9)
    R, nq = C.shape[0], Q.shape[0]
    ep = rng.integers(0, R, size=nq).astype(np.int64)
    Cf, Qf = _f32(C, dtype), _f32(Q, dtype)
    ep_d = ((Cf[ep] - Qf) ** 2).sum(-1).astype(np.float32)
    ef, ef_cap = 20, 32
    kw = dict(ef_cap=ef_cap, max_hops=4 * ef_cap)
    got = graph_expand.expand_layer0(
        torch.from_numpy(neigh0), torch.from_numpy(ok), _tq(C, dtype),
        _tq(Q, dtype), torch.from_numpy(ep), torch.from_numpy(ep_d), ef,
        **kw)
    want = jtraverse.beam_layer0(
        jnp.asarray(neigh0), jnp.asarray(ok), (jnp.asarray(Cf),),
        jnp.asarray(Qf), jnp.asarray(ep, jnp.int32), jnp.asarray(ep_d),
        jnp.int32(ef), kp=ef_cap, **kw)
    _walks_equal(got, want)


# ----------------------------------------------------------------- K4, K5

def test_sq_knn_takes_any_integer_cn():
    rng = np.random.default_rng(3)
    q8 = rng.integers(-127, 128, size=(4, 32)).astype(np.int8)
    c8 = rng.integers(-30, 31, size=(2500, 32)).astype(np.int8)
    c8[2000:] = c8[:500]                          # exact ties
    cn = (c8.astype(np.int32) ** 2).sum(1)
    assert cn.max() < 2 ** 15
    want_d, want_i = j_adc_ref.sq_knn(q8, c8, cn, 60)
    for dt in (torch.int16, torch.int64):
        d, i = adc_ops.sq_knn(torch.from_numpy(q8), torch.from_numpy(c8),
                              torch.from_numpy(cn).to(dt), 60)
        assert d.dtype == torch.int32
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("dtype", HALVES)
def test_pq_knn_takes_16bit_tables(dtype):
    """K5 casts its tables to float32: sums bit-equal to the numpy oracle
    on the upcast tables (one add at a time, ascending subspace)."""
    rng = np.random.default_rng(4)
    lut = _bits(rng.random((4, 8, 256)) * 50, dtype)
    codes_t = rng.integers(0, 256, size=(8, 2500)).astype(np.uint8)
    want_d, want_i = j_adc_ref.pq_knn(_f32(lut, dtype), codes_t, 60)
    d, i = adc_ops.pq_knn(_tq(lut, dtype), torch.from_numpy(codes_t), 60)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))


# ------------------------------------------------------- meta and refusals

def _meta_calls(dt):
    """Every entry on `meta` operands of float dtype `dt`, beside the
    same call on CPU tensors of that dtype (the plain versions)."""
    g = torch.Generator().manual_seed(0)

    def pair(*shape):
        x = torch.randn(*shape, generator=g).to(dt)
        return x, x.to("meta")

    def same(x):
        return x, x.to("meta")

    (Q, Qm), (X, Xm) = pair(5, 8), pair(300, 8)
    (C, Cm), (T, Tm) = pair(50, 4, 24), pair(3, 24)
    cand, candm = same(torch.randint(0, 50, (3, 9), generator=g))
    (Cb, Cbm) = pair(3, 9, 4, 24)
    neigh0, up, ok, Cg, Qg, entry = _walk_case("bfloat16", seed=1, R=64,
                                               d=8, nq=3)
    n0, n0m = same(torch.from_numpy(neigh0))
    upt, upm = same(torch.from_numpy(up))
    okt, okm = same(torch.from_numpy(ok))
    (Cgt, Cgm), (Qgt, Qgm) = pair(64, 8), pair(3, 8)
    ep, epm = same(torch.tensor([3, 9, 11], dtype=torch.int32))
    epd, epdm = same(torch.full((3,), 5.0))
    q8, q8m = same(torch.randint(-9, 9, (3, 16), dtype=torch.int8))
    c8, c8m = same(torch.randint(-9, 9, (200, 16), dtype=torch.int8))
    cn, cnm = same((c8.int() ** 2).sum(1).to(torch.int16))
    okr, okrm = same(torch.ones(200, dtype=torch.bool))
    (lut, lutm) = pair(3, 4, 256)
    codes, codesm = same(torch.randint(0, 256, (4, 200), dtype=torch.uint8))
    walk = dict(ef_cap=32, max_hops=64)
    return [
        (lambda *a: l2_topk.knn(*a, 7), (Q, X), (Qm, Xm)),
        (l2_topk.pairwise_sq_dists, (Q, X), (Qm, Xm)),
        (lambda *a: dce_comp.refine_topk(*a, None, 4, return_wins=True),
         (C, cand, T), (Cm, candm, Tm)),
        (dce_comp.batched_z_matrix, (Cb, T), (Cbm, Tm)),
        (dce_comp.z_matrix, (Cb[0], T[0]), (Cbm[0], Tm[0])),
        (lambda *a: graph_expand.graph_walk(*a, entry, 8, **walk),
         (n0, upt, okt, Cgt, Qgt), (n0m, upm, okm, Cgm, Qgm)),
        (lambda *a: graph_expand.expand_layer0(*a, 8, **walk),
         (n0, okt, Cgt, Qgt, ep, epd), (n0m, okm, Cgm, Qgm, epm, epdm)),
        (lambda *a: adc_topk.sq_adc_topk(*a, 20), (q8, c8, cn, okr),
         (q8m, c8m, cnm, okrm)),
        (lambda *a: adc_topk.pq_adc_topk(*a, 20), (lut, codes, okr),
         (lutm, codesm, okrm))]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16,
                                torch.float64])
def test_meta_entries_take_16bit_and_float64_operands(dt):
    """On `meta` operands every entry gives the plain version's output
    shapes and dtypes and launches nothing (it used to raise TypeError
    for anything but float32)."""
    before = _launches()
    for fn, host, meta in _meta_calls(dt):
        want, got = fn(*host), fn(*meta)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert [(tuple(t.shape), t.dtype) for t in got] == \
            [(tuple(t.shape), t.dtype) for t in want]
        assert all(t.device.type == "meta" for t in got)
    assert _launches() == before


def test_int_and_bool_operands_still_raise():
    m = "meta"
    Q, X = torch.empty(5, 8, device=m), torch.empty(300, 8, device=m)
    C, T = torch.empty(50, 4, 24, device=m), torch.empty(3, 24, device=m)
    cand = torch.empty(3, 9, dtype=torch.int64, device=m)
    for bad in (torch.int32, torch.int8, torch.bool):
        with pytest.raises(TypeError):
            l2_topk.knn(Q, X.to(bad), 7)
        with pytest.raises(TypeError):
            l2_topk.knn(Q.to(bad), X, 7)
        with pytest.raises(TypeError):
            l2_topk.pairwise_sq_dists(Q, X.to(bad))
        with pytest.raises(TypeError):
            dce_comp.refine_topk(C.to(bad), cand, T, None, 4)
        with pytest.raises(TypeError):
            dce_comp.refine_topk(C, cand, T.to(bad), None, 4)
        with pytest.raises(TypeError):
            dce_comp.batched_z_matrix(C[None, :9].to(bad), T[:1])
        n0 = torch.empty(64, 4, dtype=torch.int32, device=m)
        up = torch.empty(2, 64, 3, dtype=torch.int32, device=m)
        ok = torch.empty(64, dtype=torch.bool, device=m)
        Cg, Qg = torch.empty(64, 8, device=m), torch.empty(3, 8, device=m)
        with pytest.raises(TypeError):
            graph_expand.graph_walk(n0, up, ok, Cg.to(bad), Qg, 0, 4,
                                    ef_cap=32, max_hops=8)
        with pytest.raises(TypeError):
            graph_expand.graph_walk(n0, up, ok, Cg, Qg.to(bad), 0, 4,
                                    ef_cap=32, max_hops=8)
        lut = torch.empty(3, 4, 256, device=m)
        codes = torch.empty(4, 200, dtype=torch.uint8, device=m)
        okr = torch.empty(200, dtype=torch.bool, device=m)
        with pytest.raises(TypeError):
            adc_topk.pq_adc_topk(lut.to(bad), codes, okr, 20)
    q8 = torch.empty(3, 16, dtype=torch.int8, device=m)
    c8 = torch.empty(200, 16, dtype=torch.int8, device=m)
    for bad in (torch.float32, torch.bfloat16, torch.bool):
        with pytest.raises(TypeError):
            adc_topk.sq_adc_topk(q8, c8, torch.empty(200, dtype=bad,
                                                      device=m), okr, 20)


# ------------------------------------------------------- the secure scan

@pytest.fixture(scope="module")
def scan_case():
    """tests/test_secure_scan.py's bf16 setting: n 2000, 10 queries."""
    n, nq, seed = 2000, 10, 11
    ds = jsynth.make_dataset("deep1m", n=n, n_queries=nq, k_gt=20,
                             seed=seed)
    owner = jppanns.DataOwner(d=ds.d, sap_beta=0.5, seed=seed)
    C_sap = jdcpe.encrypt(ds.base, owner.keys.sap_key, seed=seed + 1)
    C_dce = jdce.encrypt(ds.base, owner.keys.dce_key, seed=seed + 2)
    user = jppanns.User(owner.share_keys())
    qs, ts = zip(*(user.encrypt_query(q) for q in ds.queries))
    ops = [np.asarray(a, np.float32)
           for a in (C_sap, C_dce, np.stack(qs), np.stack(ts))]
    return ds, ops, [_bits(a, "bfloat16") for a in ops]


def _port_step(n_shards, args, kp=64):
    force_device_count(8)
    try:
        devices = local_devices("cpu")[:n_shards]
        step = secure_scan.build_secure_scan_step(devices, k=10, k_prime=kp)
        ids, cand = step(*args, with_candidates=True)
    finally:
        force_device_count(None)
    return ids.numpy(), cand.numpy()


def _jax_step(args, kp=64):
    mesh = make_mesh((1,), ("data",))
    step = jscan.build_secure_scan_step(mesh, k=10, k_prime=kp)
    return np.asarray(jax.jit(step)(*args))


def _sets_equal(a, b):
    for ra, rb in zip(a, b):
        assert set(ra.tolist()) == set(rb.tolist())


def test_bf16_filter_preserves_recall_through_the_port(scan_case):
    """The port form of test_secure_scan.py's test: the port's step with
    a bf16 filter (C_sap, Q bf16; the refine float32) keeps >= 97% of the
    float32 step's k' = 64 candidates."""
    _, ops, bits = scan_case
    f32 = [torch.from_numpy(a) for a in ops]
    mixed = [_tq(bits[0], "bfloat16"), f32[1], _tq(bits[2], "bfloat16"),
             f32[3]]
    _, c32 = _port_step(4, f32)
    _, c16 = _port_step(4, mixed)
    overlap = np.mean([len(set(a) & set(b)) / 64 for a, b in zip(c32, c16)])
    assert overlap >= 0.97, overlap


@pytest.mark.parametrize("form", ["filter_bf16", "all_bf16"])
def test_bf16_step_equals_the_reference_on_the_upcast(scan_case, form):
    """The port's bf16 step (K1 and K2 read bf16 in place, compute in
    float32) against the reference's step on the float32 upcast of the
    same values: ids equal as sets; sharded = global.  The all-bf16 form
    against the reference's all-bf16 step (its filter and refine compute
    in bf16): >= 95% of ids shared."""
    _, ops, bits = scan_case
    sixteen = (0, 2) if form == "filter_bf16" else (0, 1, 2, 3)
    args = [_tq(bits[i], "bfloat16") if i in sixteen
            else torch.from_numpy(ops[i]) for i in range(4)]
    up = [_f32(bits[i], "bfloat16") if i in sixteen else ops[i]
          for i in range(4)]
    ids, _ = _port_step(4, args)
    ids1, _ = _port_step(1, args)
    np.testing.assert_array_equal(ids, ids1)
    _sets_equal(ids, _jax_step(up))
    if form == "all_bf16":
        jb = _jax_step([_jx(b, "bfloat16") for b in bits])
        shared = np.mean([len(set(a) & set(b)) / 10
                          for a, b in zip(ids.tolist(), jb.tolist())])
        assert shared >= 0.95, shared
