"""ASPE and its distance-transformation variants (paper §III-A).

Implemented *as the attack targets*: the paper's Theorems 1-2 and
Corollaries 1-2 prove these schemes are not KPA secure.  We reproduce the
schemes faithfully so `core.attacks` can demonstrate full plaintext
recovery (our Table-less "Fig. for §III").  Host numpy, a copy of the
JAX package's module: the same seeds give the same keys and leaks.

Scheme (Wong et al., SIGMOD'09, distance-comparing form):
  lift   p' = [-2p, ||p||^2, 1],  q' = [q, 1, r2/r1]  (scaled by r1)
  so     p'.q' * r1 = r1*(||p||^2 - 2 p.q + r2)  — a *linear* transform of
  dist(p,q) up to the query-independent ||q||^2 shift, which preserves
  comparisons for a fixed q.
  encrypt with an invertible M:  Enc(p') = M^T p',  Enc(q') = M^{-1} q'.

Variants expose L(C_p, T_q) = g(dist) for g in {linear, exp, log, square}.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

__all__ = ["ASPEKey", "keygen", "encrypt_db", "encrypt_query", "leak"]

Transform = Literal["linear", "exp", "log", "square"]


@dataclasses.dataclass
class ASPEKey:
    d: int
    M: np.ndarray        # (d+2, d+2) invertible
    M_inv: np.ndarray
    r1: float            # positive scale
    r2: float            # shift
    r3: float            # extra shift used by the 'square' variant


def keygen(d: int, seed: int = 0) -> ASPEKey:
    rng = np.random.default_rng(seed)
    while True:
        M = rng.standard_normal((d + 2, d + 2))
        if abs(np.linalg.det(M)) > 1e-6:
            break
    return ASPEKey(
        d=d, M=M, M_inv=np.linalg.inv(M),
        r1=float(rng.uniform(0.5, 2.0)),
        r2=float(rng.uniform(-1.0, 1.0)),
        r3=float(rng.uniform(-1.0, 1.0)),
    )


def _lift_db(P: np.ndarray) -> np.ndarray:
    n = P.shape[0]
    return np.concatenate(
        [-2.0 * P, (P * P).sum(1, keepdims=True), np.ones((n, 1))], axis=1)


def _lift_query(Q: np.ndarray, key: ASPEKey) -> np.ndarray:
    m = Q.shape[0]
    return key.r1 * np.concatenate(
        [Q, np.ones((m, 1)), np.full((m, 1), key.r2)], axis=1)


def encrypt_db(P: np.ndarray, key: ASPEKey) -> np.ndarray:
    """C_p = (p'^T M)^T — rows are encrypted DB vectors."""
    return _lift_db(np.atleast_2d(P)) @ key.M


def encrypt_query(Q: np.ndarray, key: ASPEKey) -> np.ndarray:
    """T_q = M^{-1} q' — rows are encrypted queries."""
    return _lift_query(np.atleast_2d(Q), key) @ key.M_inv.T


def leak(C_P: np.ndarray, T_Q: np.ndarray, key: ASPEKey,
         transform: Transform = "linear") -> np.ndarray:
    """What the server can compute: L(C_p, T_q) for all pairs, shape (n, m).

    raw = C_p . T_q = r1*(||p||^2 - 2 p.q + r2)  — linear in dist(p,q) up to
    the per-query constant r1*(r2 - ||q||^2); its transforms below are the
    "enhanced" ASPE variants the paper breaks in Thm 1/2 + Cor 1/2.
    """
    raw = C_P @ T_Q.T
    if transform == "linear":
        return raw
    if transform == "exp":
        # exp of the linear leak, shifted for float range; the constant shift
        # is absorbed by the attack's free unknown (Cor. 1 proof).
        return np.exp(raw - raw.max())
    if transform == "log":
        # log of the (positivized) linear leak; the constant shift is again
        # absorbed by the attack's free unknown (Cor. 2 proof).
        return np.log(raw - raw.min() + 1.0)
    if transform == "square":
        return key.r1 * raw * raw + key.r3
    raise ValueError(transform)
