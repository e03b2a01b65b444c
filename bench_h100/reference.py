"""The plain reference: Algorithm 2's answers worked out again from the
benchmark's inputs and seeds, in float64, without the program.

This file and `filters/` import numpy, torch and the benchmark's own
files, never the program.  From the base set P, the query pool Q and the
run's sub-seeds the reference restates:

  * the owner's DCPE/SAP ciphertexts of P.  The owner encrypts 4,096 rows
    at a time; chunk i draws its ball noise from a torch.Generator on the
    run's device seeded owner_noise + 7919 i: randn (bucket, d), then
    rand (bucket, 1), bucket the power of two >= the chunk's rows (at
    least 8).  The same draws give the same noise; the arithmetic here is
    float64, rounded to the float32 the server stores;
  * the user's SAP query ciphertexts (a copy of the numpy encryption);
  * the filter: the k' rows nearest each query ciphertext (`filters/`);
  * the refine: the k of those nearest the plaintext query by true
    distance.  DCE's comparison sign is exactly the sign of the true
    distance difference (paper section IV), so the refine needs neither
    the DCE keys nor the trapdoors: a wrong DCE ciphertext, trapdoor or
    tournament shows as a wrong order.

mode "reference" computes distances in float64.  mode "control" is the
reference one precision below the configuration's float32: TF32, as the
card's tensor cores compute with TF32 on -- operands rounded to 10
mantissa bits, products summed in float32 -- in the filter's distances
and in the refine, which it runs as the DCE tournament it stands for
(`dce_ref`: the step a faster refine kernel would tempt), and int4 codes
where the configuration states int8 (`filters/sq8.py`).  The benchmark's
runs never run the control; `control.py` and the tests do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dce_ref, spec

__all__ = ["MODES", "OWNER_CHUNK", "next_bucket", "sap_beta", "owner_sap",
           "user_sap", "tf32", "sq_dists", "filter_width", "answers"]

MODES = ("reference", "control")
OWNER_CHUNK = 4096          # rows the owner encrypts at a time
CHUNK_SEED_STRIDE = 7919    # seed step from one owner chunk to the next
QUERY_BLOCK = 512           # queries a step of the reference's scans
TOURNAMENT_BLOCK = 64       # queries a step of the control's tournament


def next_bucket(m: int, minimum: int = 8) -> int:
    b = max(minimum, 1)
    while b < m:
        b <<= 1
    return b


def sap_beta(P: np.ndarray, fraction: float) -> float:
    """beta at `fraction` of the legal range [sqrt(M), 2 M sqrt(d)],
    M = max |coordinate| (paper section V-A)."""
    M = float(np.max(np.abs(P)))
    lo, hi = math.sqrt(M), 2.0 * M * math.sqrt(P.shape[1])
    return lo + fraction * (hi - lo)


def owner_sap(P: torch.Tensor, s: float, beta: float, noise_seed: int,
              device) -> torch.Tensor:
    """The owner's SAP ciphertexts s p + lambda_p, |lambda_p| drawn in the
    ball of radius s beta / 4, as float32 (n, d) on `device`."""
    n, d = P.shape
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for i, start in enumerate(range(0, n, OWNER_CHUNK)):
        stop = min(start + OWNER_CHUNK, n)
        m = stop - start
        bucket = next_bucket(m)
        gen = torch.Generator(device=device).manual_seed(
            noise_seed + CHUNK_SEED_STRIDE * i)
        u = torch.randn((bucket, d), generator=gen, device=device)[:m]
        r = torch.rand((bucket, 1), generator=gen, device=device)[:m]
        u = u.double()
        u = u / (torch.linalg.norm(u, dim=1, keepdim=True) + 1e-30)
        radius = (s * beta / 4.0) * r.double() ** (1.0 / d)
        out[start:stop] = (s * P[start:stop].double() + radius * u).float()
    return out


def user_sap(Q: np.ndarray, s: float, beta: float, seed: int) -> np.ndarray:
    """The user's SAP query ciphertexts: numpy's stream, float64, then
    float32."""
    X = np.atleast_2d(np.asarray(Q, dtype=np.float64))
    n, d = X.shape
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, d))
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-30
    x = (s * beta / 4.0) * rng.uniform(0.0, 1.0, (n, 1)) ** (1.0 / d)
    return (s * X + x * u).astype(np.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest,
    ties to even), kept in float32."""
    bits = x.float().contiguous().view(torch.int32)
    odd = (bits >> 13) & 1
    return ((bits + 0xFFF + odd) & ~0x1FFF).view(torch.float32)


def sq_dists(Q: torch.Tensor, X: torch.Tensor, mode: str) -> torch.Tensor:
    """||q - x||^2 as ||q||^2 - 2 q.x + ||x||^2 for Q (b, d) against
    X (n, d), or X (b, n, d) a set of rows per query: float64 for the
    reference, the cross term in TF32 for the control's filter."""
    if mode == "reference":
        Q, X = Q.double(), X.double()
    elif mode == "control":
        Q, X = Q.float(), X.float()
    else:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    qn = (Q * Q).sum(-1)
    xn = (X * X).sum(-1)
    if mode == "control":
        Q, X = tf32(Q), tf32(X)
    if X.dim() == 2:
        return qn[:, None] - 2.0 * (Q @ X.T) + xn[None, :]
    return qn[:, None] - 2.0 * torch.einsum("bkd,bd->bk", X, Q) + xn


def filter_width(cfg: dict, k: int) -> int:
    """Candidates the filter hands the refine: k' = round(ratio_k k), at
    least k, times the configuration's refine_ratio, at most n."""
    kp = int(max(k, round(float(cfg["ratio_k"]) * k)))
    kp = max(kp, int(math.ceil(kp * float(cfg["refine_ratio"]))))
    return min(kp, int(cfg["n"]))


def _refine(P: torch.Tensor, q: torch.Tensor, cand: torch.Tensor,
            k: int) -> torch.Tensor:
    """The k candidates nearest each plaintext query, nearest first, ties
    to the earlier candidate."""
    d = sq_dists(q, P[cand], "reference")
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(cand, 1, order)


def answers(cfg: dict, k: int, P: np.ndarray, Q: np.ndarray,
            seeds: dict, device,
            mode: str = "reference") -> tuple[np.ndarray, np.ndarray]:
    """(ids (len(Q), k), candidates (len(Q), k')) int64: the answer
    Algorithm 2 gives each query of the pool, nearest first, and the
    filter's candidates it was chosen from."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = float(cfg["sap_s"])
    beta = sap_beta(P, float(cfg["beta_fraction"]))
    P_dev = torch.from_numpy(np.ascontiguousarray(P, np.float32)).to(device)
    Q_dev = torch.from_numpy(np.ascontiguousarray(Q, np.float32)).to(device)
    C = owner_sap(P_dev, s, beta, seeds["owner_noise"], device)
    Qs = torch.from_numpy(user_sap(Q, s, beta, seeds["user_sap"])).to(device)
    scan = spec.part("filters", cfg["filter"]).Filter(C, mode)
    del C
    if mode == "control":
        key = dce_ref.keygen(P.shape[1], seeds["owner_keys"])
        C_dce = dce_ref.encrypt(P_dev, key, seeds["owner_noise"])
        T = dce_ref.trapgen(Q_dev, key, seeds["user_trap"])
    kp = filter_width(cfg, k)
    out, cands = [], []
    for b in range(0, Q.shape[0], QUERY_BLOCK):
        cand = scan.candidates(Qs[b:b + QUERY_BLOCK], kp)
        cands.append(cand.cpu())
        if mode == "reference":
            out.append(_refine(P_dev, Q_dev[b:b + QUERY_BLOCK], cand,
                               k).cpu())
            continue
        for c in range(0, cand.shape[0], TOURNAMENT_BLOCK):
            rows = slice(b + c, b + c + TOURNAMENT_BLOCK)
            out.append(dce_ref.tournament(
                C_dce, T[rows], cand[c:c + TOURNAMENT_BLOCK], k, tf32).cpu())
    return (torch.cat(out).numpy().astype(np.int64),
            torch.cat(cands).numpy().astype(np.int64))
