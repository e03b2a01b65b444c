"""The port's crypto and roles against the JAX package's, on the CPU.

The numpy paths are copies, so the same seeds must give bit-identical
keys, ciphertexts and trapdoors.  The device encryptors draw their noise
from torch generators, which differ from JAX's stream, so they are held
by property, as tests/test_batched_encrypt.py holds the JAX ones: sign
exactness of DCE against true distances, interop with numpy
ciphertexts, and batch padding with real rows.
"""

import threading

import numpy as np
import pytest
import torch

from repro.core import dce as jdce
from repro.core import dcpe as jdcpe
from repro.core import ppanns as jppanns
from repro.core import wireformat as jwire
from repro.data import synth
from repro_torch.core import dce, dcpe, ppanns, wireformat

CPU = "cpu"


@pytest.fixture(scope="module")
def P():
    rng = np.random.default_rng(4)
    return rng.standard_normal((192, 48)).astype(np.float32)


def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


def _key_arrays(k):
    return {name: getattr(k, name) for name in
            ("perm1", "perm2", "M1", "M1_inv", "M2", "M2_inv", "M3",
             "M3_inv", "r", "kv")}


def _assert_same_key(a, b):
    assert (a.d, a.d_pad) == (b.d, b.d_pad)
    for name, arr in _key_arrays(a).items():
        other = getattr(b, name)
        assert arr.dtype == other.dtype
        np.testing.assert_array_equal(arr, other, err_msg=name)


# ------------------------------------------------------ numpy bit parity

@pytest.mark.parametrize("d", [2, 17, 48, 96])
def test_dce_numpy_paths_bit_identical(d):
    _assert_same_key(dce.keygen(d, seed=d), jdce.keygen(d, seed=d))
    key = jdce.keygen(d, seed=d)
    rng = np.random.default_rng(d)
    P = rng.standard_normal((20, d))
    Q = rng.standard_normal((3, d))
    for dtype in (np.float32, np.float64):
        a = dce.encrypt(P, key, seed=5, dtype=dtype)
        b = jdce.encrypt(P, key, seed=5, dtype=dtype)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert dce.trapgen(Q, key, seed=6).tobytes() == \
        jdce.trapgen(Q, key, seed=6).tobytes()
    assert dce.ciphertext_dim(d) == jdce.ciphertext_dim(d)
    assert dce.mac_cost_per_comparison(d) == jdce.mac_cost_per_comparison(d)


def test_dce_comparison_primitives_identical():
    key = jdce.keygen(16, seed=1)
    rng = np.random.default_rng(1)
    C = jdce.encrypt(rng.standard_normal((12, 16)), key, seed=2)
    t = jdce.trapgen(rng.standard_normal((1, 16)), key, seed=3)[0]
    np.testing.assert_array_equal(dce.pairwise_z_matrix(C, t),
                                  jdce.pairwise_z_matrix(C, t))
    np.testing.assert_array_equal(dce.distance_comp(C[0], C[1], t),
                                  jdce.distance_comp(C[0], C[1], t))
    args = (C[:, 0], C[:, 1], C[3, 2], C[3, 3], t)
    np.testing.assert_array_equal(dce.scores_vs_pivot(*args),
                                  jdce.scores_vs_pivot(*args))


@pytest.mark.parametrize("d", [5, 48])
def test_dcpe_numpy_paths_bit_identical(d):
    rng = np.random.default_rng(d)
    X = rng.standard_normal((30, d))
    key = dcpe.keygen(s=512.0, beta=1.5)
    assert key == dcpe.SAPKey(**vars(jdcpe.keygen(s=512.0, beta=1.5)))
    assert dcpe.encrypt(X, key, seed=3).tobytes() == \
        jdcpe.encrypt(X, jdcpe.SAPKey(**vars(key)), seed=3).tobytes()
    assert dcpe.beta_bounds(X) == jdcpe.beta_bounds(X)
    assert dcpe.suggest_beta(X, 0.03) == jdcpe.suggest_beta(X, 0.03)


@pytest.mark.parametrize("d", [16, 17])
def test_owner_and_user_bit_identical(d):
    rng = np.random.default_rng(d)
    P = rng.standard_normal((40, d)).astype(np.float32)
    t_owner = ppanns.DataOwner(d=d, sap_beta=0.7, seed=3)
    j_owner = jppanns.DataOwner(d=d, sap_beta=0.7, seed=3)
    tdb = t_owner.encrypt_database(P, build_index=False)
    jdb = j_owner.encrypt_database(P, build_index=False)
    assert tdb.C_sap.tobytes() == jdb.C_sap.tobytes()
    assert tdb.C_dce.tobytes() == jdb.C_dce.tobytes()
    assert tdb.index is None and tdb.n == jdb.n
    a, b = t_owner.encrypt_vector(P[0], seed=9), j_owner.encrypt_vector(
        P[0], seed=9)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    tu = ppanns.User(t_owner.share_keys())
    ju = jppanns.User(j_owner.share_keys())
    for q in P[:3]:
        for x, y in zip(tu.encrypt_query(q), ju.encrypt_query(q)):
            assert x.tobytes() == y.tobytes()


def test_encrypt_database_with_index_names_the_hnsw_slice():
    """The HNSW slice is ported: with build_index=True the owner builds
    the graph over C_SAP (seed + 3), bit-identical to the JAX owner's."""
    P = np.random.default_rng(8).standard_normal((60, 8)).astype(np.float32)
    tdb = ppanns.DataOwner(d=8, sap_beta=1.0, seed=4).encrypt_database(
        P, M=4, ef_construction=20)
    jdb = jppanns.DataOwner(d=8, sap_beta=1.0, seed=4).encrypt_database(
        P, M=4, ef_construction=20)
    assert tdb.C_sap.tobytes() == jdb.C_sap.tobytes()
    a, b = tdb.index.to_arrays(), jdb.index.to_arrays()
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


# ------------------------------------------------------------ wire/keys

@pytest.mark.parametrize("d", [16, 17])
def test_keys_round_trip_both_directions(d):
    j_keys = jppanns.DataOwner(d=d, sap_beta=0.3, seed=d).keys
    t_keys = ppanns.Keys.from_bytes(j_keys.to_bytes())
    _assert_same_key(t_keys.dce_key, j_keys.dce_key)
    assert vars(t_keys.sap_key) == vars(j_keys.sap_key)
    back = jppanns.Keys.from_bytes(t_keys.to_bytes(), expect_d=d)
    _assert_same_key(back.dce_key, j_keys.dce_key)
    assert vars(back.sap_key) == vars(j_keys.sap_key)
    # same key material -> the same wire members, bit for bit
    a, _ = wireformat.unpack(t_keys.to_bytes(), "ppanns-keys", 1)
    b, _ = jwire.unpack(j_keys.to_bytes(), "ppanns-keys", 1)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].tobytes() == b[name].tobytes()


def test_keys_refuse_wrong_dimension_and_version():
    blob = ppanns.DataOwner(d=16, sap_beta=1.0).keys.to_bytes()
    with pytest.raises(wireformat.WireFormatError, match="d=16"):
        ppanns.Keys.from_bytes(blob, expect_d=32)
    arrays, meta = wireformat.unpack(blob, "ppanns-keys", 1)
    v2 = wireformat.pack("ppanns-keys", 2, arrays, meta)
    with pytest.raises(wireformat.WireFormatError, match="version"):
        ppanns.Keys.from_bytes(v2)
    with pytest.raises(jwire.WireFormatError):
        jppanns.Keys.from_bytes(v2)


# ------------------------------------------- device encryptors, by property

def test_dcpe_torch_perturbation_within_ball(P):
    key = dcpe.keygen(s=512.0, beta=1.5)
    C = dcpe.encrypt_torch(P, key, _gen(9), CPU).numpy()
    assert C.shape == P.shape and C.dtype == np.float32
    pert = np.linalg.norm(C - key.s * P, axis=1)
    assert (pert <= key.s * key.beta / 4.0 + 1e-3).all()
    assert pert.std() > 0


def test_dcpe_torch_preserves_distance_comparisons(P):
    key = dcpe.keygen(s=1024.0, beta=0.5)
    C = dcpe.encrypt_torch(P, key, _gen(1), CPU).numpy()
    td = ((P[1:] - P[0]) ** 2).sum(1)
    cd = ((C[1:] - C[0]) ** 2).sum(1)
    gap = np.abs(np.sqrt(td)[:, None] - np.sqrt(td)[None, :]) > key.beta
    assert ((td[:, None] < td[None, :]) == (cd[:, None] < cd[None, :]))[
        gap].all()


@pytest.mark.parametrize("d", [48, 47])
def test_dce_torch_signs_match_true_distances(P, d):
    key = dce.keygen(d, seed=2)
    X = P[:64, :d].copy()
    q = P[64, :d].copy()
    C = dce.encrypt_torch(X, key, _gen(3), CPU).numpy()
    assert C.shape == (64, 4, dce.ciphertext_dim(d)) and C.dtype == np.float32
    T = dce.trapgen(q[None], key, seed=4)[0]
    td = ((X - q) ** 2).sum(1)
    Z = dce.pairwise_z_matrix(C, T)
    sep = np.abs(td[:, None] - td[None, :]) > 1e-3
    off = ~np.eye(64, dtype=bool)
    assert ((Z < 0) == (td[:, None] < td[None, :]))[sep & off].all()


def test_dce_torch_interops_with_numpy_ciphertexts(P):
    d = P.shape[1]
    key = dce.keygen(d, seed=5)
    C = np.concatenate([dce.encrypt(P[:96], key, seed=6),
                        dce.encrypt_torch(P[96:], key, _gen(7), CPU).numpy()])
    T = dce.trapgen(np.zeros((1, d)), key, seed=8)[0]
    td = (P * P).sum(1)
    Z = dce.pairwise_z_matrix(C, T)
    n = P.shape[0]
    mixed = (np.arange(n)[:, None] < 96) ^ (np.arange(n)[None, :] < 96)
    sep = np.abs(td[:, None] - td[None, :]) > 1e-3
    assert ((Z < 0) == (td[:, None] < td[None, :]))[mixed & sep].all()


def test_device_encryptors_are_seeded_by_their_generator(P):
    key = dce.keygen(P.shape[1], seed=1)
    a = dce.encrypt_torch(P[:8], key, _gen(4), CPU)
    b = dce.encrypt_torch(P[:8], key, _gen(4), CPU)
    c = dce.encrypt_torch(P[:8], key, _gen(5), CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_encrypt_vectors_bucketed_and_fresh(P):
    owner = ppanns.DataOwner(d=P.shape[1], sap_beta=1.0, seed=6)
    for m in (5, 7, 8, 3):
        C_sap, C_dce = owner.encrypt_vectors(P[:m], device=CPU)
        assert C_sap.shape == (m, P.shape[1]) and C_sap.dtype == np.float32
        assert C_dce.shape == (m, 4, dce.ciphertext_dim(P.shape[1]))
    a, _ = owner.encrypt_vectors(P[:4], device=CPU)
    b, _ = owner.encrypt_vectors(P[:4], device=CPU)
    assert not np.allclose(a, b)
    x, _ = owner.encrypt_vectors(P[:4], seed=11, device=CPU)
    y, _ = owner.encrypt_vectors(P[:4], seed=11, device=CPU)
    np.testing.assert_array_equal(x, y)


def test_encrypt_vectors_pads_with_real_rows_not_zeros(P, monkeypatch):
    """Zero-row padding would shrink the batch-wide DCE randomization
    scale sqrt(mean(hat^2)) and weaken the Eq. 2 blinding noise."""
    owner = ppanns.DataOwner(d=P.shape[1], sap_beta=1.0, seed=9)
    captured = {}
    orig = dce.encrypt_torch

    def spy(X, key, generator, device):
        captured["X"] = np.asarray(X)
        return orig(X, key, generator, device)

    monkeypatch.setattr(ppanns.dce, "encrypt_torch", spy)
    C_sap, _ = owner.encrypt_vectors(P[:1], device=CPU)
    X = captured["X"]
    assert X.shape[0] == 8
    np.testing.assert_array_equal(X[1:], np.broadcast_to(X[:1], X[1:].shape))
    assert C_sap.shape == (1, P.shape[1])


def test_encrypt_vectors_chunks_large_batches(P, monkeypatch):
    """Batches above 4096 rows go in 4096-row chunks, each padded to its
    own bucket; the result keeps row order."""
    owner = ppanns.DataOwner(d=8, sap_beta=1.0, seed=2)
    X = np.random.default_rng(0).standard_normal((4100, 8)).astype(
        np.float32)
    sizes = []
    orig = dce.encrypt_torch

    def spy(Xc, key, generator, device):
        sizes.append(np.asarray(Xc).shape[0])
        return orig(Xc, key, generator, device)

    monkeypatch.setattr(ppanns.dce, "encrypt_torch", spy)
    C_sap, C_dce = owner.encrypt_vectors(X, seed=3, device=CPU)
    assert sizes == [4096, 8]
    assert C_sap.shape == (4100, 8) and C_dce.shape[0] == 4100
    pert = np.linalg.norm(C_sap - 1024.0 * X, axis=1)
    assert (pert <= 1024.0 / 4.0 + 1e-2).all()     # rows stay in order


def test_encrypt_vectors_concurrent_calls_never_share_noise(P):
    owner = ppanns.DataOwner(d=P.shape[1], sap_beta=1.0, seed=8)
    out, lock = [], threading.Lock()

    def worker():
        c, _ = owner.encrypt_vectors(P[:4], device=CPU)
        with lock:
            out.append(c)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(out) == 8
    for i in range(len(out)):
        for j in range(i + 1, len(out)):
            assert not np.allclose(out[i], out[j])


def test_end_to_end_search_over_torch_encrypted_database():
    """A database ingested through the device path is searchable at the
    recall the JAX package's batched-encryption test asks for."""
    from repro_torch.serving.search_engine import SecureSearchEngine
    ds = synth.make_dataset("deep1m", n=500, n_queries=6, k_gt=20,
                            seed=13, d=32)
    beta = dcpe.suggest_beta(ds.base, fraction=0.03)
    owner = ppanns.DataOwner(d=32, sap_beta=beta, seed=13)
    C_sap, C_dce = owner.encrypt_vectors(ds.base, device=CPU)
    eng = SecureSearchEngine(C_sap, C_dce, backend="flat", device=CPU)
    user = ppanns.User(owner.share_keys())
    Q, T = zip(*(user.encrypt_query(q) for q in ds.queries))
    ids, _ = eng.search_batch(np.stack(Q), np.stack(T), 10, ratio_k=8)
    assert synth.recall_at_k(ids, ds.gt, 10) >= 0.85
