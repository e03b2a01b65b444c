"""A frozen copy of the DCE scheme (paper section IV: KeyGen, Enc,
TrapGen, DistanceComp), for the control of `reference`.

The reference ranks a query's candidates by true distance, which is what
the DCE tournament gives in exact arithmetic.  Its control computes that
tournament as a card would with TF32 products: the owner's ciphertexts
and the user's trapdoors in float64 rounded to the float32 the
configuration states, then Z = (C_o1 t) . C_p3 - (C_o2 t) . C_p4 with
both operands of each product rounded to TF32 and the sums in float32,
and the candidates ranked by wins.  Any valid encryption serves: the
noise here is its own, drawn from the run's seeds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Key", "keygen", "encrypt", "trapgen", "tournament"]

_CHUNK = 4096               # rows a step; the blinding scale is a step's


@dataclass
class Key:
    d: int
    d_pad: int
    perm1: np.ndarray
    perm2: np.ndarray
    M1: np.ndarray
    M2: np.ndarray
    M3: np.ndarray
    r: np.ndarray
    kv: np.ndarray


def _orthogonal(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return q * np.sign(np.diag(r))


def keygen(d: int, seed: int) -> Key:
    """KeyGen: orthogonal M1, M2 (h x h, h = d_pad/2 + 4) and M3
    (2 d_pad + 16 square), two permutations, r1..r4 in [0.5, 2], kv rows
    log-uniform in [1/2, 2] with kv1 kv3 = kv2 kv4."""
    rng = np.random.default_rng(seed)
    d_pad = d + (d % 2)
    h, big = d_pad // 2 + 4, 2 * d_pad + 16
    M1, M2, M3 = _orthogonal(rng, h), _orthogonal(rng, h), \
        _orthogonal(rng, big)
    kv = np.exp(rng.uniform(-np.log(2.0), np.log(2.0), size=(3, big)))
    kv = np.concatenate([kv, (kv[0] * kv[2] / kv[1])[None]])
    r = rng.uniform(0.5, 2.0, size=4)
    return Key(d, d_pad, rng.permutation(d_pad), rng.permutation(d_pad + 8),
               M1, M2, M3, r, kv)


def _hat(X: torch.Tensor, key: Key, query: bool) -> torch.Tensor:
    """Steps 1-2 of the vector randomization: pair split, pi1."""
    if key.d_pad != X.shape[1]:
        X = torch.nn.functional.pad(X, (0, 1))
    n, d = X.shape
    pairs = X.reshape(n, d // 2, 2)
    checked = torch.stack([pairs[..., 0] + pairs[..., 1],
                           pairs[..., 0] - pairs[..., 1]], -1).reshape(n, d)
    if query:
        checked = -checked
    return checked[:, torch.as_tensor(key.perm1, device=X.device)]


def encrypt(P: torch.Tensor, key: Key, seed: int) -> torch.Tensor:
    """Enc of every row of P (n, d), float64 on P's device, rounded to
    float32 (n, 4, 2 d_pad + 16)."""
    dev = P.device
    f64 = dict(dtype=torch.float64, device=dev)
    M1, M2, M3 = (torch.as_tensor(m, **f64) for m in (key.M1, key.M2, key.M3))
    r, kv = torch.as_tensor(key.r, **f64), torch.as_tensor(key.kv, **f64)
    perm2 = torch.as_tensor(key.perm2, device=dev)
    half, dp = key.d_pad // 2, key.d_pad
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty((P.shape[0], 4, 2 * dp + 16), dtype=torch.float32,
                      device=dev)
    for s in range(0, P.shape[0], _CHUNK):
        X = P[s:s + _CHUNK].double()
        m = X.shape[0]
        hat = _hat(X, key, query=False)
        scale = torch.sqrt(torch.mean(hat * hat) + 1e-9)
        alpha = scale * torch.randn((m, 2), generator=gen, **f64)
        rp = scale * torch.randn((m, 3), generator=gen, **f64)
        gamma = ((X * X).sum(1, keepdim=True) - rp[:, :1] * r[0]
                 - rp[:, 1:2] * r[1] - rp[:, 2:3] * r[2]) / r[3]
        h1 = torch.cat([hat[:, :half], alpha[:, :1], -alpha[:, :1],
                        rp[:, :1], rp[:, 1:2]], 1)
        h2 = torch.cat([hat[:, half:], alpha[:, 1:], alpha[:, 1:],
                        rp[:, 2:3], gamma], 1)
        bar = torch.cat([h1 @ M1, h2 @ M2], 1)[:, perm2]
        up, down = bar @ M3[:dp + 8], bar @ M3[dp + 8:]
        r_p = 0.5 + 1.5 * torch.rand((m, 1), generator=gen, **f64)
        out[s:s + m] = torch.stack(
            [r_p * (up + 1) / kv[0], r_p * (up - 1) / kv[1],
             r_p * (down + 1) / kv[2], r_p * (down - 1) / kv[3]], 1).float()
    return out


def trapgen(Q: torch.Tensor, key: Key, seed: int) -> torch.Tensor:
    """TrapGen of every query of Q (nq, d), float64, rounded to float32
    (nq, 2 d_pad + 16)."""
    dev = Q.device
    f64 = dict(dtype=torch.float64, device=dev)
    M1, M2, M3 = (torch.as_tensor(m, **f64) for m in (key.M1, key.M2, key.M3))
    r, kv = torch.as_tensor(key.r, **f64), torch.as_tensor(key.kv, **f64)
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = Q.double()
    n = X.shape[0]
    half = key.d_pad // 2
    hat = _hat(X, key, query=True)
    beta = torch.sqrt(torch.mean(hat * hat) + 1e-9) * torch.randn(
        (n, 2), generator=gen, **f64)
    one = torch.ones((n, 1), **f64)
    h1 = torch.cat([hat[:, :half], beta[:, :1], beta[:, :1], one * r[0],
                    one * r[1]], 1)
    h2 = torch.cat([hat[:, half:], beta[:, 1:], -beta[:, 1:], one * r[2],
                    one * r[3]], 1)
    bar = torch.cat([h1 @ M1, h2 @ M2], 1)[:, torch.as_tensor(key.perm2,
                                                             device=dev)]
    r_q = 0.5 + 1.5 * torch.rand((n, 1), generator=gen, **f64)
    w = torch.cat([bar, -bar], 1)
    return (r_q * (w @ M3) * (kv[1] * kv[3])).float()


def tournament(C: torch.Tensor, T: torch.Tensor, cand: torch.Tensor, k: int,
               round_operands) -> torch.Tensor:
    """The DCE tournament over each query's candidates: Z[i, j] < 0 iff
    candidate i is nearer than j; the k with the most wins, ties to the
    earlier candidate.  C (n, 4, D) float32 ciphertexts, T (b, D)
    trapdoors, cand (b, kp) ids; `round_operands` rounds each product's
    operands (TF32 for the control)."""
    R = C[cand]                                         # (b, kp, 4, D)
    t = T[:, None, :]
    L1, L2 = round_operands(R[:, :, 0] * t), round_operands(R[:, :, 1] * t)
    R3, R4 = round_operands(R[:, :, 2]), round_operands(R[:, :, 3])
    Z = L1 @ R3.transpose(1, 2) - L2 @ R4.transpose(1, 2)
    wins = (Z < 0).sum(-1)
    order = torch.sort(-wins, dim=1, stable=True).indices[:, :k]
    return torch.gather(cand, 1, order)
