"""Plain PyTorch versions of the l2_topk kernel's functions."""

from __future__ import annotations

import torch

from ...device import full_fp32


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
