"""Known-plaintext attacks on ASPE variants (paper §III-A, Thm 1-2, Cor 1-2).

These attacks *are part of the reproduction*: the paper motivates DCE by
proving that every ASPE variant leaking a transformation of distances is
KPA-broken.  Each attack here takes the server's view (ciphertexts + leaked
comparison scores) plus a small set of leaked plaintexts, and recovers the
remaining plaintexts to numerical precision.  Host numpy, a copy of the
JAX package's module: equal inputs give equal outputs.

Attack shapes
  linear / exp / log  (Thm 1, Cor 1-2):  d+2 leaked plaintexts suffice.
  square              (Thm 2):           0.5 d^2 + 2.5 d + 3 leaked
                                         plaintexts suffice.
"""

from __future__ import annotations

import numpy as np

from . import aspe

__all__ = [
    "recover_queries_linear",
    "recover_db_linear",
    "square_feature_dim",
    "recover_queries_square",
    "recover_db_square",
    "random_guess_error",
    "normalized_success",
    "attack_report",
]


def _invert_transform(L: np.ndarray, transform: str) -> np.ndarray:
    """Undo the monotone transform up to an additive constant, which the
    linear systems below absorb into their free (constant-slot) unknown."""
    if transform == "linear":
        return L
    if transform == "exp":
        return np.log(L)          # = raw - c
    if transform == "log":
        return np.exp(L)          # = raw + c
    raise ValueError(transform)


def recover_queries_linear(
    P_leak: np.ndarray, L_leak: np.ndarray, transform: str = "linear"
) -> tuple[np.ndarray, np.ndarray]:
    """Theorem 1 / Corollaries 1-2: recover all queries from d+2 leaked
    plaintexts.

    P_leak : (m, d) with m >= d+2 leaked database vectors.
    L_leak : (m, nq) leaked scores L(C_{p_i}, T_q).
    Returns (Q_hat (nq, d), X (nq, d+2)) where X are the recovered unknown
    vectors x = [r1 q, r1, r1 r2 (-c)] reused by `recover_db_linear`.
    """
    P_leak = np.atleast_2d(P_leak)
    m, d = P_leak.shape
    if m < d + 2:
        raise ValueError(f"need >= d+2 = {d + 2} leaked plaintexts, got {m}")
    b = _invert_transform(np.atleast_2d(L_leak), transform)      # (m, nq)
    # Rows of the coefficient matrix: [-2 p_i^T, ||p_i||^2, 1].
    A = np.concatenate(
        [-2.0 * P_leak, (P_leak ** 2).sum(1, keepdims=True), np.ones((m, 1))],
        axis=1)                                                   # (m, d+2)
    X, *_ = np.linalg.lstsq(A, b, rcond=None)                     # (d+2, nq)
    X = X.T                                                       # (nq, d+2)
    Q_hat = X[:, :d] / X[:, d:d + 1]                              # q = x[:d]/r1
    return Q_hat, X


def recover_db_linear(
    X: np.ndarray, L_db: np.ndarray, transform: str = "linear"
) -> np.ndarray:
    """Theorem 1, phase 2: recover arbitrary DB vectors from >= d+2
    recovered query unknowns X (from `recover_queries_linear`).

    L_db : (n, nq) leaked scores of the unknown DB vectors vs those queries.
    """
    X = np.atleast_2d(X)
    nq, dp2 = X.shape
    d = dp2 - 2
    if nq < d + 2:
        raise ValueError(f"need >= d+2 = {d + 2} recovered queries, got {nq}")
    b = _invert_transform(np.atleast_2d(L_db), transform)         # (n, nq)
    # raw(p, q_j) = -2 p . x_j[:d] + ||p||^2 x_j[d] + x_j[d+1]
    # unknowns y = [p (d), ||p||^2 (1)] per DB vector.
    A = np.concatenate([-2.0 * X[:, :d], X[:, d:d + 1]], axis=1)  # (nq, d+1)
    rhs = b - X[:, d + 1][None, :]                                # (n, nq)
    Y, *_ = np.linalg.lstsq(A, rhs.T, rcond=None)                 # (d+1, n)
    return Y.T[:, :d]


# ---------------------------------------------------------------------------
# Theorem 2: the 'square' variant.  L = r1 * raw^2 + r3 with
# raw = r1(||p||^2 - 2 p.q + r2).  L is linear in the degree<=4 monomial
# features of p below (dimension 0.5 d^2 + 2.5 d + 3, as in the paper).
# ---------------------------------------------------------------------------

def square_feature_dim(d: int) -> int:
    """Full-rank variant of the paper's 0.5 d^2 + 2.5 d + 3 feature map.

    The paper lists both ||p||^2 and the p_i^2 block as features; these are
    linearly dependent (||p||^2 = sum p_i^2), so we drop the ||p||^2 slot
    and absorb its 2 r1^3 r2 coefficient into the p_i^2 block — one fewer
    feature, same attack.
    """
    return d * (d - 1) // 2 + 3 * d + 2     # == 0.5 d^2 + 2.5 d + 2


def _square_features(P: np.ndarray) -> np.ndarray:
    """phi(p) = [||p||^4, ||p||^2 p, p^2, {p_i p_j}_{i<j}, p, 1]."""
    P = np.atleast_2d(P)
    n, d = P.shape
    norm2 = (P ** 2).sum(1, keepdims=True)
    iu, ju = np.triu_indices(d, k=1)
    cross = P[:, iu] * P[:, ju]
    return np.concatenate(
        [norm2 ** 2, norm2 * P, P ** 2, cross, P, np.ones((n, 1))],
        axis=1)


def recover_queries_square(
    P_leak: np.ndarray, L_leak: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Theorem 2: recover queries from 0.5 d^2+2.5 d+3 leaked plaintexts.

    Solves phi(P_leak) w_q = L(:, q); the feature weights satisfy
    w[0] = r1^3, w[1:d+1] = -4 r1^3 q  =>  q = -w[1:d+1] / (4 w[0]).
    Returns (Q_hat, W) with W reused by `recover_db_square`.
    """
    P_leak = np.atleast_2d(P_leak)
    m, d = P_leak.shape
    D = square_feature_dim(d)
    if m < D:
        raise ValueError(f"need >= {D} leaked plaintexts, got {m}")
    Phi = _square_features(P_leak)                               # (m, D)
    W, *_ = np.linalg.lstsq(Phi, np.atleast_2d(L_leak), rcond=None)  # (D, nq)
    W = W.T                                                      # (nq, D)
    Q_hat = -W[:, 1:d + 1] / (4.0 * W[:, :1])
    return Q_hat, W


def recover_db_square(
    Q_hat: np.ndarray, W: np.ndarray, L_db: np.ndarray, d: int
) -> np.ndarray:
    """Theorem 2, phase 2: recover arbitrary DB vectors from recovered
    queries.

    L(p, q) is quadratic in q:  L = r1^3[(||p||^2+r2) - 2 p.q]^2 + r3, so we
    regress L(p, .) against the query features [1, q, q_i q_j (i<=j)] and
    read p off the linear slot: c_i = -4 r1^3 (||p||^2 + r2) p_i, with
    r1^3 = W[:,0] and r2 = W[:,d+1-slot]/(2 r1^3) recovered in phase 1 and
    ||p||^2 = sum_i c_ii / (4 r1^3).
    """
    Q_hat = np.atleast_2d(Q_hat)
    nq = Q_hat.shape[0]
    need = 1 + d + d * (d + 1) // 2
    if nq < need:
        raise ValueError(f"need >= {need} recovered queries, got {nq}")
    r1c = float(np.median(W[:, 0]))                  # r1^3
    # p_i^2-slot coefficients are 4 r1^3 q_i^2 + 2 r1^3 r2 (the absorbed
    # ||p||^2 term): average the residual over i and the query set.
    sq_slot = W[:, d + 1:2 * d + 1]                  # (nq, d)
    r2 = float(np.median(
        (sq_slot - 4.0 * r1c * Q_hat ** 2).mean(1) / (2.0 * r1c)))
    iu, ju = np.triu_indices(d, k=1)
    PhiQ = np.concatenate(
        [np.ones((nq, 1)), Q_hat, Q_hat ** 2, Q_hat[:, iu] * Q_hat[:, ju]],
        axis=1)                                      # (nq, 1+2d+d(d-1)/2)
    C, *_ = np.linalg.lstsq(PhiQ, np.atleast_2d(L_db).T, rcond=None)
    C = C.T                                          # (n, feat)
    c_lin = C[:, 1:d + 1]                            # -4 r1^3 (||p||^2+r2) p
    c_sq = C[:, d + 1:2 * d + 1]                     # 4 r1^3 p_i^2
    norm2 = c_sq.sum(1, keepdims=True) / (4.0 * r1c)
    return -c_lin / (4.0 * r1c * (norm2 + r2))


def attack_roundtrip(
    d: int = 8, n: int = 64, nq: int = 24, transform: str = "linear",
    seed: int = 0,
) -> dict:
    """End-to-end §III demonstration used by tests and benchmarks: encrypt,
    leak, attack, report max recovery error."""
    rng = np.random.default_rng(seed)
    key = aspe.keygen(d, seed=seed)
    P = rng.standard_normal((n, d))
    Q = rng.standard_normal((nq, d))
    C_P = aspe.encrypt_db(P, key)
    T_Q = aspe.encrypt_query(Q, key)
    L = aspe.leak(C_P, T_Q, key, transform)      # (n, nq)

    if transform == "square":
        D = square_feature_dim(d)
        leak_idx = np.arange(D)
        Q_hat, W = recover_queries_square(P[leak_idx], L[leak_idx])
        P_rest = np.setdiff1d(np.arange(n), leak_idx)
        P_hat = recover_db_square(Q_hat, W, L[P_rest], d) \
            if len(P_rest) else np.zeros((0, d))
        q_err = float(np.abs(Q_hat - Q).max())
        p_err = float(np.abs(P_hat - P[P_rest]).max()) if len(P_rest) else 0.0
    else:
        leak_idx = np.arange(d + 2)
        Q_hat, X = recover_queries_linear(P[leak_idx], L[leak_idx], transform)
        P_rest = np.setdiff1d(np.arange(n), leak_idx)
        P_hat = recover_db_linear(X, L[P_rest], transform)
        q_err = float(np.abs(Q_hat - Q).max())
        p_err = float(np.abs(P_hat - P[P_rest]).max())
    return {"transform": transform, "query_err": q_err, "db_err": p_err}


# ---------------------------------------------------------------------------
# Normalized attack success (sec, DESIGN.md §14).  A raw recovery
# error is meaningless across data scales: DCPE ciphertexts live at
# scale s*sigma while ASPE plaintexts are unit-scale, so "err = 0.3"
# could be total recovery or total failure.  Every attack therefore
# reports success = 1 - err / baseline, where the baseline is the error
# an attacker achieves with ZERO leakage (guessing a fresh sample from
# the data distribution): 1.0 = perfect recovery, 0.0 = no better than
# chance, clamped at 0 for attacks that do worse than guessing.
# ---------------------------------------------------------------------------

def random_guess_error(
    X: np.ndarray, n_trials: int = 8, seed: int = 12345,
) -> float:
    """Empirical zero-leakage baseline for max-abs recovery error on the
    target matrix `X`: the median error of guessing a row-shuffled
    resample of X itself (a draw from the same empirical distribution,
    uninformed about which row is which)."""
    X = np.atleast_2d(np.asarray(X, np.float64))
    rng = np.random.default_rng(seed)
    errs = []
    for _ in range(n_trials):
        guess = X[rng.permutation(X.shape[0])]
        errs.append(float(np.abs(guess - X).max()))
    return float(np.median(errs))


def normalized_success(err: float, baseline: float) -> float:
    """[0, 1] attack success: 1 at exact recovery, 0 at (or below) the
    zero-leakage guessing baseline."""
    if baseline <= 0.0:
        return 0.0
    return float(max(0.0, 1.0 - float(err) / float(baseline)))


def attack_report(
    d: int = 8, n: int = 64, nq: int = 24, transform: str = "linear",
    seed: int = 0,
) -> dict:
    """`attack_roundtrip` with the errors normalized against the
    random-guess baseline — the ASPE rows of BENCH_attacks.json."""
    raw = attack_roundtrip(d=d, n=n, nq=nq, transform=transform, seed=seed)
    rng = np.random.default_rng(seed)
    base_q = random_guess_error(rng.standard_normal((nq, d)))
    base_p = random_guess_error(rng.standard_normal((n, d)))
    return {
        **raw,
        "query_baseline": base_q,
        "db_baseline": base_p,
        "query_success": normalized_success(raw["query_err"], base_q),
        "db_success": normalized_success(raw["db_err"], base_p),
    }
