"""Distance-Comparison-Preserving Encryption (DCPE) — Scale-and-Perturb (SAP).

Paper §III-B / §V-A, Algorithm 1 (after Fuchsbauer et al., SCN'22).

SAP encrypts ``p -> s*p + lambda_p`` where ``lambda_p`` is drawn uniformly
from the ball B(0, s*beta/4).  Distances between ciphertexts approximate
``s * dist`` within ``+- s*beta/2`` (metric distance), which yields the
beta-DCP guarantee: ``dist(o,q) < dist(p,q) - beta  =>  the encrypted
comparison agrees``.  Ciphertexts keep the original dimensionality, so an
encrypted distance costs exactly a plaintext distance — this is what makes
the HNSW *filter* phase cheap.

As in the paper we never decrypt: the modified Algorithm 1 stores no
decryption helper.  IND-KPA security is inherited from [10].
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from ..device import resolve_device

__all__ = ["SAPKey", "keygen", "encrypt", "encrypt_torch", "suggest_beta",
           "beta_bounds"]


@dataclasses.dataclass
class SAPKey:
    s: float      # scaling factor (paper uses s = 1024)
    beta: float   # perturbation factor, in [sqrt(M), 2 M sqrt(d)]


def beta_bounds(P: np.ndarray) -> tuple[float, float]:
    """Legal beta range [sqrt(M), 2 M sqrt(d)] with M = max |coordinate|."""
    M = float(np.max(np.abs(P)))
    d = P.shape[-1]
    return float(np.sqrt(M)), float(2.0 * M * np.sqrt(d))


def keygen(s: float = 1024.0, beta: float = 1.0) -> SAPKey:
    return SAPKey(s=float(s), beta=float(beta))


def suggest_beta(P: np.ndarray, fraction: float = 0.05) -> float:
    """A beta at `fraction` of the legal range — the paper tunes beta per
    dataset so the filter-phase recall ceiling sits near 0.5 (Fig. 4)."""
    lo, hi = beta_bounds(P)
    return float(lo + fraction * (hi - lo))


def encrypt(X: np.ndarray, key: SAPKey, seed: int = 0) -> np.ndarray:
    """Enc_SAP(s, beta, p) for a batch — Algorithm 1, vectorized.

    Draws lambda uniformly from the ball of radius s*beta/4 via the
    standard (direction ~ N(0, I)/||.||, radius ~ R * U^(1/d)) construction.
    """
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    n, d = X.shape
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, d))                       # Line 1
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-30
    x = (key.s * key.beta / 4.0) * rng.uniform(0.0, 1.0, (n, 1)) ** (1.0 / d)
    lam = x * u                                           # Lines 2-4
    return (key.s * X + lam).astype(np.float32)           # Line 5


def encrypt_torch(X, key: SAPKey, generator: torch.Generator | None = None,
                  device=None) -> torch.Tensor:
    """Enc_SAP for a batch on the device — the owner-side ingestion path,
    counterpart of the JAX package's `encrypt_jax`.

    Same ball-noise construction as `encrypt`, in float32, with the noise
    drawn from `generator` (which must live on `device`; None uses
    torch's default generator there).  Torch's random stream differs
    from numpy's and JAX's, so the result is held by property, not bit
    for bit.  `device=None` means the card.  Returns a float32 tensor.
    """
    device = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    X = torch.atleast_2d(X)
    n, d = X.shape
    u = torch.randn((n, d), generator=generator, device=device)
    u = u / (torch.linalg.norm(u, dim=1, keepdim=True) + 1e-30)
    x = (key.s * key.beta / 4.0) * torch.rand(
        (n, 1), generator=generator, device=device) ** (1.0 / d)
    return (key.s * X + x * u).to(torch.float32)
