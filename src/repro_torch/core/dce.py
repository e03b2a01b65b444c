"""Distance Comparison Encryption (DCE) — the paper's core contribution (Section IV).

DCE encrypts database vectors so that the *sign* of
``Z = DistanceComp(C_o, C_p, T_q) = 2 r_o r_p r_q (dist(o,q) - dist(p,q))``
exactly answers "is o closer to q than p?", while leaking only that
comparison bit (Theorem 3 / Theorem 4 of the paper).

Division of labour (mirrors the paper's system model, Fig. 1):
  * KeyGen / Enc run at the *data owner* — host-side, numpy float64.
  * TrapGen runs at the *user* — host-side, numpy float64.
  * DistanceComp runs at the *server* — batched on the card, float32.

Hardware adaptation vs. the paper's C++ heap walk: comparisons are
restructured into batched matrix forms (``scores_vs_pivot`` for the heap
refine, ``pairwise_z_matrix`` for the tournament refine; see
repro_torch.kernels.dce_comp for the CUDA tile kernel).

The numpy key generation, encryption and trapdoor code is a copy of the
JAX package's, so the same seeds give bit-identical keys, ciphertexts and
trapdoors in both packages.

Numerical note: the paper only requires M1, M2, M3 to be random invertible
matrices. We draw them *orthogonal* (QR of a Gaussian) — a measure-zero
subfamily that keeps every security argument intact (the simulator story in
§VI never uses non-orthogonality) while making the float pipeline perfectly
conditioned, so float32 server-side comparisons keep their sign fidelity
even at d≈1000.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import full_fp32, resolve_device

__all__ = [
    "DCEKey",
    "keygen",
    "encrypt",
    "encrypt_torch",
    "trapgen",
    "distance_comp",
    "scores_vs_pivot",
    "pairwise_z_matrix",
    "ciphertext_dim",
    "mac_cost_per_comparison",
]


def ciphertext_dim(d: int) -> int:
    """Dimension of each of the 4 ciphertext component vectors: 2d+16."""
    d_pad = d + (d % 2)
    return 2 * d_pad + 16


def mac_cost_per_comparison(d: int) -> int:
    """Multiply-accumulate count of one DistanceComp: 4d+32 (paper §IV-B)."""
    return 4 * d + 32


@dataclasses.dataclass
class DCEKey:
    """Secret key SK = {M1, M2, M3, pi1, pi2, r1..r4, kv1..kv4}."""

    d: int                 # original dimensionality
    d_pad: int             # d rounded up to even (vector-splitting needs pairs)
    perm1: np.ndarray      # pi1 : R^d_pad -> R^d_pad           (int indices)
    perm2: np.ndarray      # pi2 : R^(d_pad+8) -> R^(d_pad+8)   (int indices)
    M1: np.ndarray         # (h, h), h = d_pad/2 + 4
    M1_inv: np.ndarray
    M2: np.ndarray
    M2_inv: np.ndarray
    M3: np.ndarray         # (2d_pad+16, 2d_pad+16)
    M3_inv: np.ndarray
    r: np.ndarray          # (4,) shared scalars r1..r4
    kv: np.ndarray         # (4, 2d_pad+16), kv1*kv3 == kv2*kv4

    @property
    def cdim(self) -> int:
        return 2 * self.d_pad + 16


def _orthogonal(rng: np.random.Generator, n: int) -> np.ndarray:
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    # Sign-fix for a proper Haar draw.
    return q * np.sign(np.diag(r))


def keygen(d: int, seed: int = 0) -> DCEKey:
    """KeyGen(1^zeta, d) -> SK  (paper §IV-B (1))."""
    if d < 2:
        raise ValueError("DCE requires d >= 2")
    rng = np.random.default_rng(seed)
    d_pad = d + (d % 2)
    h = d_pad // 2 + 4
    big = 2 * d_pad + 16

    M1 = _orthogonal(rng, h)
    M2 = _orthogonal(rng, h)
    M3 = _orthogonal(rng, big)
    # kv entries log-uniform in [1/2, 2] — mild conditioning by design.
    kv123 = np.exp(rng.uniform(-np.log(2.0), np.log(2.0), size=(3, big)))
    kv4 = kv123[0] * kv123[2] / kv123[1]          # enforce kv1∘kv3 == kv2∘kv4
    kv = np.concatenate([kv123, kv4[None]], axis=0)
    r = rng.uniform(0.5, 2.0, size=4)

    return DCEKey(
        d=d,
        d_pad=d_pad,
        perm1=rng.permutation(d_pad),
        perm2=rng.permutation(d_pad + 8),
        M1=M1,
        M1_inv=M1.T.copy(),
        M2=M2,
        M2_inv=M2.T.copy(),
        M3=M3,
        M3_inv=M3.T.copy(),
        r=r,
        kv=kv,
    )


def _pair_split(x: np.ndarray, negate: bool) -> np.ndarray:
    """Step 1 of vector randomization (Eq. 1).

    p -> [p1+p2, p1-p2, p3+p4, p3-p4, ...];  queries additionally negated,
    so that  p̌ᵀ q̌ = -2 pᵀq.
    """
    n, d = x.shape
    pairs = x.reshape(n, d // 2, 2)
    s = pairs[..., 0] + pairs[..., 1]
    m = pairs[..., 0] - pairs[..., 1]
    out = np.empty((n, d), dtype=x.dtype)
    out[:, 0::2] = s
    out[:, 1::2] = m
    return -out if negate else out


def _randomized(
    x: np.ndarray, key: DCEKey, rng: np.random.Generator, is_query: bool
) -> np.ndarray:
    """Vector randomization phase (Eq. 1–4): R^d -> R^(d_pad+8)."""
    x = np.asarray(x, dtype=np.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    n, d = x.shape
    if d != key.d:
        raise ValueError(f"vector dim {d} != key dim {key.d}")
    if key.d_pad != d:                                  # odd d: zero-pad
        x = np.concatenate([x, np.zeros((n, 1), x.dtype)], axis=1)
    d = key.d_pad
    half = d // 2

    checked = _pair_split(x, negate=is_query)           # Step 1
    hat = checked[:, key.perm1]                         # Step 2: pi1
    scale = np.sqrt(np.mean(hat * hat) + 1e-9)          # blend-in scale for pads

    r1, r2, r3, r4 = key.r
    if is_query:
        # Step 3 (Eq. 3): q̂ -> (q̂1, q̂2) with per-query beta1, beta2.
        beta = rng.normal(0.0, scale, size=(n, 2))
        h1 = np.concatenate(
            [hat[:, :half], beta[:, :1], beta[:, :1],
             np.full((n, 1), r1), np.full((n, 1), r2)], axis=1)
        h2 = np.concatenate(
            [hat[:, half:], beta[:, 1:], -beta[:, 1:],
             np.full((n, 1), r3), np.full((n, 1), r4)], axis=1)
        # Step 4 (Eq. 4): q̄ = pi2([M1^{-1} q̂1 ; M2^{-1} q̂2]).
        t = np.concatenate([h1 @ key.M1_inv.T, h2 @ key.M2_inv.T], axis=1)
    else:
        # Step 3 (Eq. 2): p̂ -> (p̂1, p̂2) with per-vector alpha/r' randomness
        # and gamma_p = (||p||^2 - r'1 r1 - r'2 r2 - r'3 r3) / r4.
        alpha = rng.normal(0.0, scale, size=(n, 2))
        rp = rng.normal(0.0, scale, size=(n, 3))
        norm2 = np.sum(x * x, axis=1, keepdims=True)
        gamma = (norm2 - rp[:, :1] * r1 - rp[:, 1:2] * r2 - rp[:, 2:3] * r3) / r4
        h1 = np.concatenate(
            [hat[:, :half], alpha[:, :1], -alpha[:, :1], rp[:, :1], rp[:, 1:2]],
            axis=1)
        h2 = np.concatenate(
            [hat[:, half:], alpha[:, 1:], alpha[:, 1:], rp[:, 2:3], gamma],
            axis=1)
        # Step 4 (Eq. 4): p̄ = pi2([p̂1ᵀ M1 ; p̂2ᵀ M2]).
        t = np.concatenate([h1 @ key.M1, h2 @ key.M2], axis=1)

    bar = t[:, key.perm2]
    return bar[0] if squeeze else bar


def encrypt(
    P: np.ndarray, key: DCEKey, seed: int = 1, dtype=np.float32
) -> np.ndarray:
    """Enc(p, SK) -> C_p  (paper §IV-B (2)).

    Returns ciphertexts of shape (n, 4, 2d+16): the four component vectors
    (p̄'1, p̄'2, p̄'3, p̄'4) of Eq. 13.
    """
    P = np.atleast_2d(np.asarray(P, dtype=np.float64))
    rng = np.random.default_rng(seed)
    bar = _randomized(P, key, rng, is_query=False)      # (n, d+8)
    n = bar.shape[0]
    big = key.cdim
    up = bar @ key.M3[: key.d_pad + 8]                  # p̄ᵀ M_up   (Eq. 10)
    down = bar @ key.M3[key.d_pad + 8:]                 # p̄ᵀ M_down
    ones = np.ones((1, big))
    rp = rng.uniform(0.5, 2.0, size=(n, 1))             # r_p > 0   (Eq. 13)
    C = np.stack(
        [
            rp * (up + ones) / key.kv[0],
            rp * (up - ones) / key.kv[1],
            rp * (down + ones) / key.kv[2],
            rp * (down - ones) / key.kv[3],
        ],
        axis=1,
    )
    return C.astype(dtype)


def _key_torch_arrays(key: DCEKey, device: torch.device) -> tuple:
    """Device copies of the key material, cached on the key object per
    device."""
    cache = getattr(key, "_torch_arrays", None)
    if cache is None:
        cache = {}
        object.__setattr__(key, "_torch_arrays", cache)
    if device not in cache:
        f32 = dict(dtype=torch.float32, device=device)
        cache[device] = (
            torch.as_tensor(key.perm1, dtype=torch.int64, device=device),
            torch.as_tensor(key.perm2, dtype=torch.int64, device=device),
            torch.as_tensor(key.M1, **f32),
            torch.as_tensor(key.M2, **f32),
            torch.as_tensor(key.M3, **f32),
            torch.as_tensor(key.r, **f32),
            torch.as_tensor(key.kv, **f32),
        )
    return cache[device]


def encrypt_torch(P, key: DCEKey, generator: torch.Generator | None = None,
                  device=None) -> torch.Tensor:
    """Batched Enc on the device — the owner-side ingestion path,
    counterpart of the JAX package's `encrypt_jax`.

    The same Eq. 1–4 / Eq. 13 pipeline as `encrypt`, restructured so the
    heavy steps are two (n, h) x (h, h) products and one
    (n, d_pad+8) x (d_pad+8, 2d_pad+16) product, in float32 end to end
    (TF32 off): the orthogonal key matrices keep the pipeline
    conditioned, the same argument that lets the server compare in
    float32.  Fresh randomness comes from `generator` (which must live
    on `device`; None uses torch's default generator there), so rows
    encrypted here and by `encrypt` under the same key interoperate in
    one database.  The randomization scale is taken over the whole
    batch, so callers pad batches with real rows, never zeros.
    `device=None` means the card.  Returns a (n, 4, 2d+16) float32
    tensor.
    """
    device = resolve_device(device)
    full_fp32()
    X = torch.atleast_2d(torch.as_tensor(P, dtype=torch.float32,
                                         device=device))
    n, d = X.shape
    if d != key.d:
        raise ValueError(f"vector dim {d} != key dim {key.d}")
    if key.d_pad != d:                                  # odd d: zero-pad
        X = torch.nn.functional.pad(X, (0, 1))
        d = key.d_pad
    perm1, perm2, M1, M2, M3, r, kv = _key_torch_arrays(key, device)
    half = d // 2

    # Step 1 (Eq. 1): pair split [p1+p2, p1-p2, ...].
    pairs = X.reshape(n, half, 2)
    checked = torch.stack(
        [pairs[..., 0] + pairs[..., 1], pairs[..., 0] - pairs[..., 1]],
        dim=-1).reshape(n, d)
    hat = checked[:, perm1]                             # Step 2: pi1
    scale = torch.sqrt(torch.mean(hat * hat) + 1e-9)

    # Step 3 (Eq. 2): per-vector alpha / r' randomness and gamma_p.
    alpha = scale * torch.randn((n, 2), generator=generator, device=device)
    rp = scale * torch.randn((n, 3), generator=generator, device=device)
    norm2 = torch.sum(X * X, dim=1, keepdim=True)
    gamma = (norm2 - rp[:, :1] * r[0] - rp[:, 1:2] * r[1]
             - rp[:, 2:3] * r[2]) / r[3]
    h1 = torch.cat(
        [hat[:, :half], alpha[:, :1], -alpha[:, :1], rp[:, :1], rp[:, 1:2]],
        dim=1)
    h2 = torch.cat(
        [hat[:, half:], alpha[:, 1:], alpha[:, 1:], rp[:, 2:3], gamma],
        dim=1)
    # Step 4 (Eq. 4): p̄ = pi2([p̂1ᵀ M1 ; p̂2ᵀ M2]).
    t = torch.cat([h1 @ M1, h2 @ M2], dim=1)
    bar = t[:, perm2]

    # Component split (Eq. 10 / Eq. 13).
    up = bar @ M3[: d + 8]
    down = bar @ M3[d + 8:]
    r_p = 0.5 + 1.5 * torch.rand((n, 1), generator=generator, device=device)
    return torch.stack(
        [
            r_p * (up + 1.0) / kv[0],
            r_p * (up - 1.0) / kv[1],
            r_p * (down + 1.0) / kv[2],
            r_p * (down - 1.0) / kv[3],
        ],
        dim=1,
    )


def trapgen(
    Q: np.ndarray, key: DCEKey, seed: int = 2, dtype=np.float32
) -> np.ndarray:
    """TrapGen(q, SK) -> T_q  (paper §IV-B (3)).  Shape (m, 2d+16)."""
    Q = np.atleast_2d(np.asarray(Q, dtype=np.float64))
    rng = np.random.default_rng(seed)
    bar = _randomized(Q, key, rng, is_query=True)       # (m, d+8)
    m = bar.shape[0]
    w = np.concatenate([bar, -bar], axis=1)             # [q̄ᵀ, -q̄ᵀ]
    rq = rng.uniform(0.5, 2.0, size=(m, 1))             # r_q > 0
    T = rq * (w @ key.M3_inv.T) * (key.kv[1] * key.kv[3])   # Eq. 15
    return T.astype(dtype)


# ---------------------------------------------------------------------------
# Server-side comparison primitives (pure array math; numpy arrays or
# tensors).  The CUDA-tiled versions live in repro_torch.kernels.dce_comp.
# ---------------------------------------------------------------------------

def distance_comp(C_o, C_p, T_q):
    """DistanceComp(C_o, C_p, T_q) -> Z  (paper §IV-B (4)).

    Z < 0  <=>  dist(o, q) < dist(p, q).   Z = 2 r_o r_p r_q (d_oq - d_pq).
    """
    return ((C_o[..., 0, :] * C_p[..., 2, :]
             - C_o[..., 1, :] * C_p[..., 3, :]) * T_q).sum(-1)


def scores_vs_pivot(O1, O2, p3, p4, t):
    """Batched Z of many candidates o_i against one pivot p (heap refine).

    O1, O2: (n, D) components 1/2 of the candidates; p3, p4: (D,) components
    3/4 of the pivot; t: (D,) trapdoor.  Returns (n,) Z scores.
    """
    return (O1 * (p3 * t)).sum(-1) - (O2 * (p4 * t)).sum(-1)


def pairwise_z_matrix(C, t):
    """All-pairs Z matrix for a candidate set — the matrix-shaped refine.

    Z[i, j] = DistanceComp(C_i, C_j, t)  =>  Z[i, j] < 0 iff dist_i < dist_j.
    Implemented as two (n, D) x (D, n) products, so the tournament refine
    (rank candidates by win counts) runs at matrix-product throughput.
    """
    term1 = (C[:, 0, :] * t) @ C[:, 2, :].T
    term2 = (C[:, 1, :] * t) @ C[:, 3, :].T
    return term1 - term2
