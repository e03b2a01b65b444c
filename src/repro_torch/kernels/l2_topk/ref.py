"""Plain PyTorch versions of the l2_topk kernels' functions."""

from __future__ import annotations

import torch

from ...device import full_fp32
from ..common import running_topk_scan


def pairwise_sq_dists(Q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """||q - x||^2 for all pairs; Q: (nq, d), X: (n, d) -> (nq, n).

    Same restructuring as the kernel, `||q||^2 - 2 q.x + ||x||^2`, with
    the cross term a true-fp32 matrix product (TF32 off)."""
    full_fp32()
    Q = Q.to(torch.float32)
    X = X.to(torch.float32)
    qn = (Q * Q).sum(-1, keepdim=True)
    xn = (X * X).sum(-1)[None, :]
    return qn - 2.0 * Q @ X.T + xn


def knn(Q: torch.Tensor, X: torch.Tensor, k: int):
    """Exact k-NN: returns (dists (nq, k), idx (nq, k)) ascending, ties
    to the lowest index."""
    d = pairwise_sq_dists(Q, X)
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def scan_knn(Q: torch.Tensor, X: torch.Tensor, k: int, *,
             chunk: int = 4096):
    """Exact k-NN by a streaming scan, as the reference's `ops.knn`
    runs it: X in `chunk`-row blocks of plain distance tiles, each folded
    into a running top-k by a stable merge, so no (nq, n) matrix exists.
    -> (dists (nq, k) ascending, ids (nq, k) int64), ties to the lowest
    id; k = min(k, n), chunk = min(chunk, n); the last block is computed
    at its ragged size and padded with +inf, so X is never copied."""
    nq = Q.shape[0]
    n = X.shape[0]
    k = min(k, n)
    chunk = min(chunk, n)
    Q = Q.to(torch.float32).contiguous()

    def dist_fn(start):
        d_blk = pairwise_sq_dists(Q, X[start:start + chunk])
        short = chunk - d_blk.shape[1]
        if short:
            d_blk = torch.nn.functional.pad(d_blk, (0, short),
                                            value=float("inf"))
        return d_blk

    return running_topk_scan(dist_fn, n, nq, k, chunk, Q.device)
