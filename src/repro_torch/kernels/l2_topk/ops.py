"""Public wrappers around the l2_topk kernel.

`knn` streams the database through the distance kernel chunk by chunk
and keeps a running top-k, so no (nq, n) distance matrix is ever
materialized: the counterpart of `repro.kernels.l2_topk.ops.knn`.
"""

from __future__ import annotations

import torch

from ..common import running_topk_scan
from .l2_topk import pairwise_sq_dists

__all__ = ["knn", "pairwise_sq_dists"]


def knn(Q: torch.Tensor, X: torch.Tensor, k: int, *, chunk: int = 4096):
    """Exact k-NN of each query against X.

    Q: (nq, d), X: (n, d)  ->  (dists (nq, k) ascending, idx (nq, k)
    int64), ties to the lowest id.  Scans X in `chunk`-row blocks: the
    distance kernel produces each block and a stable merge folds it into
    the running state.  `k = min(k, n)` and `chunk = min(chunk, n)`; the
    last block is computed at its ragged size and padded with +inf, so X
    is never copied.
    """
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
