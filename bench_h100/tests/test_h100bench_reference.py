"""The plain reference against brute force on a tiny set, TF32
rounding, and the control: the reference one precision down must come
out not correct under each cell's limits."""

import math

import numpy as np
import pytest
import torch

from bench_h100 import control, datagen, dce_ref, reference
from bench_h100.tests import tiny


def _brute(cfg, k, P, Q, sd):
    """Algorithm 2 row by row in numpy float64: the owner's SAP noise
    from the same draws, the user's from numpy's stream, k' rows by
    ciphertext distance, then the k of them by true distance."""
    n, d = P.shape
    s = cfg["sap_s"]
    M = float(np.abs(P).max())
    beta = math.sqrt(M) + cfg["beta_fraction"] * (
        2 * M * math.sqrt(d) - math.sqrt(M))
    C = np.empty((n, d))
    for i, start in enumerate(range(0, n, 4096)):
        rows = min(4096, n - start)
        bucket = max(8, 1 << (rows - 1).bit_length())
        gen = torch.Generator().manual_seed(sd["owner_noise"] + 7919 * i)
        u = torch.randn((bucket, d), generator=gen)[:rows].double().numpy()
        r = torch.rand((bucket, 1), generator=gen)[:rows].double().numpy()
        u = u / (np.linalg.norm(u, axis=1, keepdims=True) + 1e-30)
        C[start:start + rows] = s * P[start:start + rows] \
            + (s * beta / 4) * r ** (1 / d) * u
    C = C.astype(np.float32).astype(np.float64)
    rng = np.random.default_rng(sd["user_sap"])
    u = rng.standard_normal(Q.shape)
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-30
    x = (s * beta / 4) * rng.uniform(0.0, 1.0, (Q.shape[0], 1)) ** (1 / d)
    Qs = (s * Q.astype(np.float64) + x * u).astype(np.float32)
    kp = min(n, max(int(max(k, round(cfg["ratio_k"] * k))),
                    math.ceil(round(cfg["ratio_k"] * k)
                              * cfg["refine_ratio"])))
    if cfg["filter"] == "sq8":
        Cf = C.astype(np.float32)
        off = (Cf.min(0) + Cf.max(0)) / 2
        scale = np.float32(float(np.abs(Cf - off).max()) / 127)
        enc = lambda X: np.clip(np.rint((X - off) / scale), -127, 127)
        c8, q8 = enc(Cf).astype(np.int64), enc(Qs).astype(np.int64)
    out = np.empty((Q.shape[0], k), np.int64)
    cands = np.empty((Q.shape[0], kp), np.int64)
    for i in range(Q.shape[0]):
        if cfg["filter"] == "sq8":
            key = (c8 * c8).sum(1) - 2 * c8 @ q8[i]
        else:
            key = ((C - Qs[i].astype(np.float64)) ** 2).sum(1)
        cand = cands[i] = np.argsort(key, kind="stable")[:kp]
        true = ((P[cand].astype(np.float64) - Q[i]) ** 2).sum(1)
        out[i] = cand[np.argsort(true, kind="stable")[:k]]
    return out, cands


@pytest.mark.parametrize("name", tiny.CELLS)
def test_reference_matches_brute_force(name):
    c = tiny.cell(name, n=2000, d=16, pool=64)
    k = c.traffic["k"]
    sd = datagen.seeds(tiny.SEED)
    P, Q = (x.numpy() for x in datagen.mixture(c.cfg, 64, sd["data"],
                                               torch.device("cpu")))
    got, cand = reference.answers(c.cfg, k, P, Q, sd, "cpu")
    want, want_cand = _brute(c.cfg, k, P, Q, sd)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(cand, 1), np.sort(want_cand, 1))


def test_dce_copy_compares_as_true_distances():
    """The frozen DCE scheme: Z(o, p) from float32 ciphertexts and
    trapdoors, products in float64, has the sign of d(o, q) - d(p, q)
    wherever the two distances differ by more than 1e-3 of d(o, q) (the
    rounding of the ciphertexts to float32 flips closer pairs), and the
    tournament ranks by it."""
    sd = datagen.seeds(tiny.SEED)
    c = tiny.cell(tiny.CELLS[2], n=2000, d=16)
    P, Q = datagen.mixture(c.cfg, 64, sd["data"], torch.device("cpu"))
    key = dce_ref.keygen(16, sd["owner_keys"])
    C = dce_ref.encrypt(P, key, sd["owner_noise"]).double()
    T = dce_ref.trapgen(Q, key, sd["user_trap"]).double()
    cand = torch.stack([torch.randperm(2000, generator=torch.Generator()
                                       .manual_seed(i))[:100]
                        for i in range(64)])
    R = C[cand]
    Z = ((R[:, :, 0] * T[:, None]) @ R[:, :, 2].transpose(1, 2)
         - (R[:, :, 1] * T[:, None]) @ R[:, :, 3].transpose(1, 2))
    true = ((P[cand].double() - Q[:, None].double()) ** 2).sum(-1)
    diff = true[:, :, None] - true[:, None, :]
    clear = diff.abs() > 1e-3 * true[:, :, None]
    assert clear.float().mean() > 0.95
    assert torch.equal(torch.sign(Z)[clear], torch.sign(diff)[clear])
    Cf, Tf = C.float(), T.float()
    got = dce_ref.tournament(Cf, Tf, cand, 100, lambda x: x.double())
    Rf = Cf[cand]
    Z = ((Rf[:, :, 0] * Tf[:, None]).double()
         @ Rf[:, :, 2].double().transpose(1, 2)
         - (Rf[:, :, 1] * Tf[:, None]).double()
         @ Rf[:, :, 3].double().transpose(1, 2))
    wins = (Z < 0).sum(-1)
    want = torch.gather(cand, 1, torch.sort(-wins, dim=1,
                                            stable=True).indices)
    assert torch.equal(got, want)


def test_tf32_rounds_to_ten_mantissa_bits():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 3 * 2 ** -11, one + 2 ** -10,
                      -(one + 2 ** -12), 3.0])
    want = torch.tensor([one, one + 2 ** -9, one + 2 ** -10, -one, 3.0])
    assert torch.equal(reference.tf32(x), want)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_is_not_correct(name):
    # the cell's width on a sixteenth of its rows: a second on the host
    out = control.control(tiny.cell(name, n=65536, d=128, pool=256),
                          tiny.SEED, "cpu")
    assert not out["passes"], out
