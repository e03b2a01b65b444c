"""The port's kernels against the JAX package's, on the CPU.

The same numpy inputs go through `repro` (Pallas in interpret mode, as
tests/test_kernels.py runs it) and through `repro_torch` on CPU tensors,
where each wrapper runs its plain PyTorch version.  Tolerances: ids are
exactly equal; l2 distances within 1e-5 of ||q||^2 + ||x||^2 and Z within
1e-5 * max|Z| (both fp32 sums, taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dce as jdce
from repro.kernels import common as jcommon
from repro.kernels.dce_comp import ops as j_dce_ops
from repro.kernels.dce_comp import ref as j_dce_ref
from repro.kernels.l2_topk import ops as j_l2_ops
from repro_torch.kernels import _build, common
from repro_torch.kernels.dce_comp import dce_comp
from repro_torch.kernels.dce_comp import ops as t_dce_ops
from repro_torch.kernels.dce_comp import ref as t_dce_ref
from repro_torch.kernels.l2_topk import l2_topk
from repro_torch.kernels.l2_topk import ops as t_l2_ops
from repro_torch.kernels.l2_topk import ref as t_l2_ref

L2_RTOL = 1e-5
Z_RTOL = 1e-5


@pytest.fixture(autouse=True)
def no_kernel_launch(monkeypatch):
    """On the CPU no wrapper may reach the CUDA build or launch path."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached the kernel launch path")
    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------- common

@pytest.mark.parametrize("n,minimum,maximum", [
    (0, 1, None), (1, 8, None), (5, 8, None), (9, 8, None),
    (4096, 8, 4096), (3000, 128, 4096)])
def test_next_bucket_matches_reference(n, minimum, maximum):
    assert common.next_bucket(n, minimum, maximum) == \
        jcommon.next_bucket(n, minimum, maximum)


def test_pad_helpers_match_reference():
    x = np.arange(15, dtype=np.float32).reshape(3, 5)
    for axis, mult, val in [(0, 4, 0.0), (1, 8, -1.0), (1, 5, 2.0)]:
        np.testing.assert_array_equal(
            common.pad_to(_t(x), axis, mult, val).numpy(),
            np.asarray(jcommon.pad_to(jnp.asarray(x), axis, mult, val)))
    assert common.padded_size(130, 128) == jcommon.padded_size(130, 128)


@pytest.mark.parametrize("k,most,want", [
    (1025, 1024, [513, 512]), (1600, 1024, [800, 800]),
    (2049, 1024, [683, 683, 683]), (3000, 1024, [1000, 1000, 1000]),
    (7, 3, [3, 2, 2])])
def test_pass_sizes_cover_k_in_near_equal_passes(k, most, want):
    """The fused top-k kernels' passes above MAX_KP: sum k, at most
    `most` each, and above `most` every pass takes at least most / 2 (so
    every pass of K1 and K4 takes their kernels' 8- and 16-query
    variants, which have floor-key versions)."""
    got = common.pass_sizes(k, most)
    assert got == want and sum(got) == k and max(got) <= most
    assert all(p >= most // 2 for k2 in range(most + 1, 5 * most, 97)
               for p in common.pass_sizes(k2, most))


def test_build_name_covers_shared_headers(tmp_path, monkeypatch):
    """The library is named by a hash of the sources and of the headers
    they include: editing only a .cuh must name (and so build) a new
    library, or a stale one would be loaded.  Runs no nvcc."""
    (tmp_path / "a.cu").write_text('#include "sel.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "sel.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    (tmp_path / "sel.cuh").write_text("#pragma once\nint c;\n")
    edited = _build.library_path()
    assert edited != first and edited.parent == _build.BUILD_DIR
    (tmp_path / "more.cuh").write_text("int d;\n")
    assert _build.library_path() != edited
    (tmp_path / "notes.txt").write_text("not a source")
    (tmp_path / "more.cuh").unlink()
    assert _build.library_path() == edited


# ---------------------------------------------------------------- l2_topk

@pytest.mark.parametrize("nq,n,d", [
    (1, 1, 2), (3, 17, 5), (8, 128, 64), (16, 300, 100), (5, 200, 960),
    (33, 70, 96)])
def test_pairwise_sq_dists_matches_jax(nq, n, d):
    rng = np.random.default_rng(nq * 1000 + n + d)
    Q = (1024.0 * rng.standard_normal((nq, d))).astype(np.float32)
    X = (1024.0 * rng.standard_normal((n, d))).astype(np.float32)
    want = np.asarray(j_l2_ops.pairwise_sq_dists(
        jnp.asarray(Q), jnp.asarray(X), interpret=True))
    got = l2_topk.pairwise_sq_dists(_t(Q), _t(X)).numpy()
    scale = (Q * Q).sum(1)[:, None] + (X * X).sum(1)[None, :]
    assert (np.abs(got - want) <= L2_RTOL * scale).all()
    assert not any(l2_topk.launches.values())


@pytest.mark.parametrize("n,k,chunk", [
    (100, 5, 32), (257, 20, 64), (1000, 10, 256), (10, 15, 4),
    (64, 64, 64), (130, 7, 4096)])
def test_knn_matches_jax(n, k, chunk):
    """Ragged n and chunk, k > n, chunk > n: ids exactly equal."""
    rng = np.random.default_rng(n + k)
    Q = rng.standard_normal((7, 24)).astype(np.float32)
    X = rng.standard_normal((n, 24)).astype(np.float32)
    jd, ji = j_l2_ops.knn(jnp.asarray(Q), jnp.asarray(X), k, chunk=chunk,
                          interpret=True)
    td, ti = t_l2_ops.knn(_t(Q), _t(X), k, chunk=chunk)
    assert ti.shape == (7, min(k, n))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("chunk", [3, 8, 64])
def test_knn_ties_go_to_lowest_id(chunk):
    """Duplicated rows with small integer coordinates give exactly equal
    distances whatever the sum order: the lowest id must come first, as
    in the JAX package (jax.lax.top_k keeps the lowest index)."""
    rng = np.random.default_rng(chunk)
    base = rng.integers(-3, 4, size=(12, 6)).astype(np.float32)
    X = np.concatenate([base, base, base[:5]])          # ids i, i+12, i+24
    Q = rng.integers(-3, 4, size=(5, 6)).astype(np.float32)
    k = 20
    _, ji = j_l2_ops.knn(jnp.asarray(Q), jnp.asarray(X), k, chunk=chunk,
                         interpret=True)
    td, ti = t_l2_ops.knn(_t(Q), _t(X), k, chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _, ri = t_l2_ref.knn(_t(Q), _t(X), k)
    np.testing.assert_array_equal(ti.numpy(), ri.numpy())
    d, i = td.numpy(), ti.numpy()
    for row_d, row_i in zip(d, i):
        for a in range(k - 1):
            if row_d[a] == row_d[a + 1]:
                assert row_i[a] < row_i[a + 1]


def test_knn_unfilled_slots_never_happen_below_n():
    Q = np.zeros((2, 4), np.float32)
    X = np.ones((3, 4), np.float32)
    d, i = t_l2_ops.knn(_t(Q), _t(X), 10, chunk=2)
    assert i.shape == (2, 3) and (i.numpy() >= 0).all()
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 2], [0, 1, 2]])


# ---------------------------------------------------------------- dce_comp

def _cipher_sets(B, n, d, seed, dup=False):
    """Real DCE ciphertexts of B candidate sets and B trapdoors.  With
    `dup`, every set repeats its first candidates, so wins tie."""
    rng = np.random.default_rng(seed)
    key = jdce.keygen(d, seed=seed)
    P = rng.standard_normal((B, n, d))
    if dup:
        P[:, n // 2:] = P[:, : n - n // 2]
    Qp = rng.standard_normal((B, d))
    C = jdce.encrypt(P.reshape(B * n, d), key, seed=seed + 1).reshape(
        B, n, 4, -1)
    T = jdce.trapgen(Qp, key, seed=seed + 2)
    return C, T


@pytest.mark.parametrize("B,n,d", [(1, 5, 4), (3, 48, 17), (4, 40, 96),
                                   (2, 33, 128)])
def test_batched_z_matrix_matches_jax(B, n, d):
    C, T = _cipher_sets(B, n, d, seed=B + n + d)
    want = np.asarray(j_dce_ops.batched_z_matrix(
        jnp.asarray(C), jnp.asarray(T), interpret=True))
    got = dce_comp.batched_z_matrix(_t(C), _t(T)).numpy()
    assert np.abs(got - want).max() <= Z_RTOL * np.abs(want).max()
    assert not any(dce_comp.launches.values())


@pytest.mark.parametrize("n,d", [(4, 4), (60, 17), (130, 33)])
def test_z_matrix_matches_jax(n, d):
    C, T = _cipher_sets(1, n, d, seed=n + d)
    want = np.asarray(j_dce_ops.z_matrix(jnp.asarray(C[0]),
                                         jnp.asarray(T[0]), interpret=True))
    got = dce_comp.z_matrix(_t(C[0]), _t(T[0])).numpy()
    assert np.abs(got - want).max() <= Z_RTOL * np.abs(want).max()
    np.testing.assert_array_equal(
        t_dce_ref.win_counts(_t(C[0]), _t(T[0])).numpy(),
        np.asarray(j_dce_ref.win_counts(jnp.asarray(C[0]),
                                        jnp.asarray(T[0]))))


@pytest.mark.parametrize("B,n,want", [
    (1, 512, (2, 7)),        # z_matrix at n 512: 16 row tiles x 7 = 112
    (32, 80, (2, 1)),        # one j-tile: nothing to split
    (32, 160, (5, 2)),       # 32 x 2 x 2 = 128 blocks
    (32, 320, (5, 1)),       # 4 j-tiles do not fit in 2 ranges: no split
    (3, 600, (5, 5)),
    (64, 80, (3, 1))])
def test_z_column_split_emulated_equals_plain(B, n, want):
    """K3's block plan (`z_plan`: the most j-tile ranges over a third
    grid dimension, with the fewest rows a thread, that fit the SMs once)
    and the split kernel's blocks emulated: every Z element is written by
    exactly one block, whole (both fp32 chains over the full depth), so on
    integer-valued ciphertexts the stitched Z equals the plain version
    and the JAX reference bit for bit."""
    ri, splits = dce_comp.z_plan(B, n, 132)
    assert (ri, splits) == want
    rng = np.random.default_rng(n)
    D = 24
    C = rng.integers(-4, 5, size=(B, n, 4, D)).astype(np.float32)
    T = rng.integers(-3, 4, size=(B, D)).astype(np.float32)
    TI, njt = 16 * ri, -(-n // 80)
    per = -(-njt // splits)
    Z = np.full((B, n, n), np.nan, np.float32)
    for b in range(B):
        L1, L2 = C[b, :, 0] * T[b], C[b, :, 1] * T[b]
        for i0 in range(0, n, TI):
            for z in range(-(-njt // per)):
                for jt in range(z * per, min(njt, (z + 1) * per)):
                    rows, cols = slice(i0, i0 + TI), slice(80 * jt,
                                                           80 * jt + 80)
                    assert np.isnan(Z[b, rows, cols]).all()
                    Z[b, rows, cols] = (L1[rows] @ C[b, cols, 2].T
                                        - L2[rows] @ C[b, cols, 3].T)
    want_z = t_dce_ref.batched_z_matrix(_t(C), _t(T)).numpy()
    np.testing.assert_array_equal(Z, want_z)
    np.testing.assert_array_equal(
        Z, np.asarray(j_dce_ref.batched_z_matrix(jnp.asarray(C),
                                                 jnp.asarray(T))))
    blocks = B * -(-n // TI) * -(-njt // per)
    assert blocks <= 132 or (ri, splits) == (5, 1)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_batched_top_k_by_wins_matches_jax(dup, masked):
    B, n, k = 4, 40, 12
    C, T = _cipher_sets(B, n, 24, seed=7, dup=dup)
    valid = None
    if masked:
        rng = np.random.default_rng(8)
        valid = rng.random((B, n)) < 0.7
        valid[0, :] = True
        valid[1, :5] = True
        valid[1, 5:] = False                  # fewer real slots than k
    want = np.asarray(j_dce_ops.batched_top_k_by_wins(
        jnp.asarray(C), jnp.asarray(T), k,
        valid=None if valid is None else jnp.asarray(valid),
        interpret=True))
    got = t_dce_ops.batched_top_k_by_wins(
        _t(C), _t(T), k, valid=None if valid is None else _t(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    if masked:                                 # padded slots rank last
        sel = np.take_along_axis(valid, got.numpy(), axis=1)
        assert not sel[1, 5:].any() and sel[1, :5].all()


@pytest.mark.parametrize("dup", [False, True])
def test_top_k_by_wins_matches_jax(dup):
    C, T = _cipher_sets(1, 50, 16, seed=3, dup=dup)
    for k in (1, 10, 50, 80):
        want = np.asarray(j_dce_ops.top_k_by_wins(
            jnp.asarray(C[0]), jnp.asarray(T[0]), k, interpret=True))
        got = t_dce_ops.top_k_by_wins(_t(C[0]), _t(T[0]), k)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            t_dce_ref.top_k_by_wins(_t(C[0]), _t(T[0]), k).numpy(),
            np.asarray(j_dce_ref.top_k_by_wins(
                jnp.asarray(C[0]), jnp.asarray(T[0]), k)))
