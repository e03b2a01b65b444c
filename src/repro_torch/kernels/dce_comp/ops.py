"""Public wrappers for the dce_comp kernels: the tournament refine.

Counterpart of `repro.kernels.dce_comp.ops`.  `jax.lax.top_k` keeps the
lowest index among equal values and `torch.topk` promises no tie order,
so the top-k by wins here is a stable ascending sort of `-wins`.
`refine_topk` is the whole refine of a batch (gather, Z, wins, top-k) in
one fused kernel call on the card.  The public entry points are wrapped
by the opt-in kernel profiler (`obs.profiler`).
"""

from __future__ import annotations

import torch

from ...obs.profiler import instrument as _instrument
from .dce_comp import batched_z_matrix, refine_topk, z_matrix
from .ref import batched_wins

__all__ = ["z_matrix", "batched_z_matrix", "top_k_by_wins",
           "batched_top_k_by_wins", "refine_topk"]


def top_k_by_wins(C: torch.Tensor, t: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k of a DCE-encrypted candidate set (refine phase).

    Ranks the n candidates by pairwise-comparison win counts from the Z
    kernel.  DCE comparisons reflect true distances (Theorem 3), so win
    counts sort identically to distances.  -> (k,) int64 local indices.
    """
    return batched_top_k_by_wins(C[None], t[None], k)[0]


def batched_top_k_by_wins(C: torch.Tensor, T: torch.Tensor, k: int, *,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """Batched refine: per-query exact top-k of DCE candidate sets.

    C: (B, n, 4, D) candidate ciphertexts, T: (B, D) trapdoors, valid:
    optional (B, n) bool mask of real candidate slots -> (B, k) int64
    local indices, descending win count (ascending true distance), ties
    to the lowest index.  With `valid`, wins count against real rivals
    only and padded slots get -1, so they rank last.
    """
    wins = batched_wins(batched_z_matrix(C, T), valid)
    k = min(k, C.shape[1])
    return torch.sort(-wins, dim=-1, stable=True).indices[:, :k]


top_k_by_wins = _instrument("dce_comp.top_k_by_wins", top_k_by_wins)
batched_top_k_by_wins = _instrument("dce_comp.batched_top_k_by_wins",
                                    batched_top_k_by_wins)
refine_topk = _instrument("dce_comp.refine_topk", refine_topk)
