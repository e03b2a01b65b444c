"""Squared-L2 distance tiles of the flat filter: CUDA kernel and dispatch.

The kernel (`csrc/l2_topk.cu`) replaces the Pallas TPU kernel
`repro/kernels/l2_topk/l2_topk.py :: pairwise_sq_dists`.  For CUDA
tensors the wrapper launches it (or raises); for CPU tensors it runs the
plain version beside it, `plain_pairwise_sq_dists`.
"""

from __future__ import annotations

import torch

from .. import _build
from ..common import on_cpu
from .ref import pairwise_sq_dists as plain_pairwise_sq_dists

__all__ = ["pairwise_sq_dists", "plain_pairwise_sq_dists", "launches"]

# Kernel launches since import; a caller auditing a run resets it to 0.
launches = 0

_ARGTYPES = [_build.PTR, _build.PTR, _build.PTR,
             _build.INT, _build.INT, _build.INT, _build.INT, _build.PTR]


def pairwise_sq_dists(Q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """All-pairs ||q - x||^2.  Q: (nq, d), X: (n, d) -> (nq, n) float32.

    CUDA tensors must be float32 and contiguous (row-major); the output
    is allocated here and the kernel runs on the current stream without
    synchronizing."""
    global launches
    if on_cpu(Q, X):
        return plain_pairwise_sq_dists(Q, X)
    if Q.dim() != 2 or X.dim() != 2 or Q.shape[1] != X.shape[1]:
        raise ValueError(f"pairwise_sq_dists needs (nq, d) and (n, d), "
                         f"got {tuple(Q.shape)} and {tuple(X.shape)}")
    if Q.dtype != torch.float32 or X.dtype != torch.float32:
        raise TypeError(f"the l2 kernel takes float32, got {Q.dtype} "
                        f"and {X.dtype}")
    if not (Q.is_contiguous() and X.is_contiguous()):
        raise ValueError("the l2 kernel takes contiguous Q and X")
    nq, d = Q.shape
    n = X.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=Q.device)
    fn = _build.function("repro_l2_sq_dists", _ARGTYPES)
    err = fn(Q.data_ptr(), X.data_ptr(), out.data_ptr(), nq, n, d,
             Q.device.index, torch.cuda.current_stream(Q.device).cuda_stream)
    _build.check(err, "l2_topk.pairwise_sq_dists")
    launches += 1
    return out
