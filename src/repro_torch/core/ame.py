"""Asymmetric Matrix Encryption (AME) — the paper's strongest-security,
highest-cost baseline (§III-C; Zheng et al., TDSC 2024).

Faithfulness note (recorded in DESIGN.md §7): the TDSC construction is
rebuilt here from its published *interface and cost profile*, which is what
the paper's comparison depends on:
  * secret key: 32 matrices in R^{(2d+6) x (2d+6)}                  [check]
  * each DB vector  -> 32 vectors in R^{2d+6}                        [check]
  * each query      -> 16 matrices in R^{(2d+6) x (2d+6)}            [check]
  * one comparison  = 16 vector-matrix products + 16 inner products
    = 16[(2d+6)^2 + (2d+6)] = 64 d^2 + 416 d + 672 MACs  (paper: +676) [check]
  * leakage: comparison sign only                                    [check]

Construction: lift a(x) = [x, ||x||^2, 1, noise_pad] in R^{2d+6}; a sparse
query-dependent form S(q) satisfies a(o)^T S(q) b(p) = dist(o,q)-dist(p,q).
S is additively split into 16 random shares S_t, each hidden by a distinct
matrix pair: u_t(o) = r_o Ma_t^T a(o), v_t(p) = r_p Mb_t^{-1} b(p),
W_t(q) = r_q Ma_t^{-1} S_t Mb_t, and

    Compare(o,p,q) = sum_t u_t(o)^T W_t(q) v_t(p)
                   = r_o r_p r_q (dist(o,q) - dist(p,q)).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["AMEKey", "keygen", "encrypt", "trapgen", "compare",
           "mac_cost_per_comparison", "N_SHARES"]

N_SHARES = 16


def mac_cost_per_comparison(d: int) -> int:
    m = 2 * d + 6
    return N_SHARES * (m * m + m)        # = 64 d^2 + 416 d + 672


@dataclasses.dataclass
class AMEKey:
    d: int
    Ma: np.ndarray       # (16, m, m)
    Ma_inv: np.ndarray
    Mb: np.ndarray       # (16, m, m)   -> 32 matrices total
    Mb_inv: np.ndarray

    @property
    def m(self) -> int:
        return 2 * self.d + 6


def _orthogonal(rng: np.random.Generator, n: int) -> np.ndarray:
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return q * np.sign(np.diag(r))


def keygen(d: int, seed: int = 0) -> AMEKey:
    rng = np.random.default_rng(seed)
    m = 2 * d + 6
    Ma = np.stack([_orthogonal(rng, m) for _ in range(N_SHARES)])
    Mb = np.stack([_orthogonal(rng, m) for _ in range(N_SHARES)])
    return AMEKey(d=d, Ma=Ma, Ma_inv=np.transpose(Ma, (0, 2, 1)).copy(),
                  Mb=Mb, Mb_inv=np.transpose(Mb, (0, 2, 1)).copy())


def _lift(X: np.ndarray, m: int, rng: np.random.Generator) -> np.ndarray:
    """a(x) = [x, ||x||^2, 1, noise pad] in R^m (pads hit zero rows of S)."""
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    n, d = X.shape
    pad = rng.standard_normal((n, m - d - 2))
    return np.concatenate(
        [X, (X * X).sum(1, keepdims=True), np.ones((n, 1)), pad], axis=1)


def _S_of_q(q: np.ndarray, m: int) -> np.ndarray:
    """Sparse S with a(o)^T S b(p) = dist(o,q) - dist(p,q)."""
    d = q.shape[0]
    S = np.zeros((m, m))
    S[:d, d + 1] = -2.0 * q        # -2 o.q   (times b's '1' slot)
    S[d, d + 1] = 1.0              # +||o||^2
    S[d + 1, :d] = 2.0 * q         # +2 p.q   (times a's '1' slot)
    S[d + 1, d] = -1.0             # -||p||^2
    return S


def encrypt(P: np.ndarray, key: AMEKey, seed: int = 1,
            dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """DB vector -> 32 vectors: (U (n,16,m), V (n,16,m))."""
    rng = np.random.default_rng(seed)
    m = key.m
    A = _lift(P, m, rng)                              # (n, m)
    B = _lift(P, m, rng)                              # fresh pad noise
    r = rng.uniform(0.5, 2.0, size=(A.shape[0], 1, 1))
    U = r * np.einsum("nm,tmk->ntk", A, key.Ma)       # u_t = Ma_t^T a
    V = r * np.einsum("nm,tkm->ntk", B, key.Mb_inv)   # v_t = Mb_t^{-1} b
    return U.astype(dtype), V.astype(dtype)


def trapgen(Q: np.ndarray, key: AMEKey, seed: int = 2,
            dtype=np.float32) -> np.ndarray:
    """Query -> 16 matrices W_t = r_q Ma_t^{-1} S_t Mb_t; shape (nq,16,m,m)."""
    Q = np.atleast_2d(np.asarray(Q, dtype=np.float64))
    rng = np.random.default_rng(seed)
    m = key.m
    out = np.empty((Q.shape[0], N_SHARES, m, m))
    for qi, q in enumerate(Q):
        S = _S_of_q(q, m)
        shares = rng.standard_normal((N_SHARES - 1, m, m))
        shares = np.concatenate([shares, (S - shares.sum(0))[None]], axis=0)
        rq = rng.uniform(0.5, 2.0)
        # batched matmul chain (a 3-operand np.einsum without optimize=True
        # would evaluate as a naive O(m^4) loop)
        out[qi] = rq * (key.Ma_inv @ shares @ key.Mb)
    return out.astype(dtype)


def compare(U_o: np.ndarray, V_p: np.ndarray, W_q: np.ndarray) -> np.ndarray:
    """sum_t u_t^T W_t v_t;  negative  <=>  dist(o,q) < dist(p,q).

    U_o: (..., 16, m); V_p: (..., 16, m); W_q: (16, m, m).
    Cost per comparison: 16 vec-mat products + 16 inner products (O(d^2)).
    """
    left = np.einsum("...tm,tmk->...tk", U_o, W_q)
    return np.einsum("...tk,...tk->...", left, V_p)
