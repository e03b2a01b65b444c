"""Plain PyTorch versions of the dce_comp kernels' functions."""

from __future__ import annotations

import torch

from ...device import full_fp32


def z_matrix(C: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """All-pairs DCE Z-scores.  C: (n, 4, D), t: (D,) -> (n, n).

    Z[i, j] = DistanceComp(C_i, C_j, t) = 2 r_i r_j r_q (d_i - d_j);
    Z[i, j] < 0  iff  dist(i, q) < dist(j, q).
    """
    return batched_z_matrix(C[None], t[None])[0]


def win_counts(C: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """wins[i] = #{j != i : dist(i,q) < dist(j,q)}.  The diagonal is
    excluded: Z_ii is mathematically 0 but floats to +-eps."""
    Z = z_matrix(C, t)
    offdiag = ~torch.eye(Z.shape[0], dtype=torch.bool, device=Z.device)
    return ((Z < 0) & offdiag).sum(dim=1).to(torch.int32)


def top_k_by_wins(C: torch.Tensor, t: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k closest candidates (descending win count, ties to
    the lowest index)."""
    wins = win_counts(C, t)
    return torch.sort(-wins, stable=True).indices[:k]


def batched_z_matrix(C: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Per-query all-pairs Z tensors.  C: (B, n, 4, D), T: (B, D) ->
    (B, n, n), as two true-fp32 batched products (TF32 off)."""
    full_fp32()
    C = C.to(torch.float32)
    T = T.to(torch.float32)
    left1 = C[:, :, 0, :] * T[:, None, :]
    left2 = C[:, :, 1, :] * T[:, None, :]
    z1 = torch.bmm(left1, C[:, :, 2, :].transpose(1, 2))
    z2 = torch.bmm(left2, C[:, :, 3, :].transpose(1, 2))
    return z1 - z2


def batched_wins(Z: torch.Tensor,
                 valid: torch.Tensor | None = None) -> torch.Tensor:
    """Win counts of (B, n, n) Z tensors -> (B, n) int32: a win of i over
    j is Z[b, i, j] < 0 with j != i (Z_ii is mathematically 0 but floats
    to +-eps) and j valid; with `valid`, an invalid slot gets -1, so it
    ranks after every real one."""
    n = Z.shape[-1]
    offdiag = ~torch.eye(n, dtype=torch.bool, device=Z.device)[None]
    win_mask = (Z < 0) & offdiag
    if valid is not None:
        win_mask = win_mask & valid[:, None, :]    # wins vs real rivals only
    wins = win_mask.sum(dim=-1, dtype=torch.int32)
    if valid is not None:
        wins = torch.where(valid, wins, -1)        # padded slots rank last
    return wins


def refine_topk(C_dce: torch.Tensor, cand: torch.Tensor, T: torch.Tensor,
                valid: torch.Tensor | None, k: int, *,
                return_wins: bool = False):
    """The tournament refine as a chain of torch ops: gather the
    candidates' ciphertexts, Z, win counts, and a stable sort by
    descending wins (ties to the lowest slot).  -> ids (B, k) int64, -1
    where the selected slot is invalid; k = min(k, n); with return_wins
    also the (B, n) int32 win counts."""
    wins = batched_wins(batched_z_matrix(C_dce[cand], T), valid)
    k = min(k, cand.shape[1])
    local = torch.sort(-wins, dim=-1, stable=True).indices[:, :k]
    ids = torch.gather(cand, 1, local)
    if valid is not None:
        ids = torch.where(torch.gather(valid, 1, local), ids, -1)
    return (ids, wins) if return_wins else ids
