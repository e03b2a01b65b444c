"""Batched DCE DistanceComp (pairwise Z) tiles: CUDA kernel and dispatch.

The kernel (`csrc/dce_comp.cu`) replaces both Pallas TPU kernels of
`repro/kernels/dce_comp/dce_comp.py`: `batched_z_matrix` directly, and
`z_matrix` as its B = 1 case.  For CUDA tensors the wrapper launches it
(or raises); for CPU tensors it runs the plain version beside it.
"""

from __future__ import annotations

import torch

from .. import _build
from ..common import on_cpu
from .ref import batched_z_matrix as plain_batched_z_matrix

__all__ = ["batched_z_matrix", "z_matrix", "plain_batched_z_matrix",
           "plain_z_matrix", "launches"]

# Kernel launches since import (z_matrix counts here too: it is the
# batched kernel with B = 1); a caller auditing a run resets it to 0.
launches = 0

_MAX_BATCH = 65535          # one grid z-slice per query
_ARGTYPES = [_build.PTR, _build.PTR, _build.PTR,
             _build.INT, _build.INT, _build.INT, _build.INT, _build.PTR]


def batched_z_matrix(C: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Per-query all-pairs Z tensors for a batch of candidate sets.

    C: (B, n, 4, D) candidate ciphertexts, T: (B, D) trapdoors ->
    (B, n, n) float32.  CUDA tensors must be float32 and contiguous; the
    output is allocated here and the kernel runs on the current stream
    without synchronizing."""
    global launches
    if on_cpu(C, T):
        return plain_batched_z_matrix(C, T)
    if (C.dim() != 4 or C.shape[2] != 4 or T.dim() != 2
            or T.shape != (C.shape[0], C.shape[3])):
        raise ValueError(f"batched_z_matrix needs C (B, n, 4, D) and "
                         f"T (B, D), got {tuple(C.shape)} and "
                         f"{tuple(T.shape)}")
    if C.dtype != torch.float32 or T.dtype != torch.float32:
        raise TypeError(f"the dce_comp kernel takes float32, got {C.dtype} "
                        f"and {T.dtype}")
    if not (C.is_contiguous() and T.is_contiguous()):
        raise ValueError("the dce_comp kernel takes contiguous C and T")
    B, n, _, D = C.shape
    if B > _MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's {_MAX_BATCH}")
    Z = torch.empty((B, n, n), dtype=torch.float32, device=C.device)
    fn = _build.function("repro_dce_batched_z", _ARGTYPES)
    err = fn(C.data_ptr(), T.data_ptr(), Z.data_ptr(), B, n, D,
             C.device.index, torch.cuda.current_stream(C.device).cuda_stream)
    _build.check(err, "dce_comp.batched_z_matrix")
    launches += 1
    return Z


def z_matrix(C: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """All-pairs DCE Z-scores for one candidate set.  C: (n, 4, D),
    t: (D,) -> (n, n): the batched kernel with B = 1."""
    return batched_z_matrix(C[None], t[None])[0]


def plain_z_matrix(C: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return plain_batched_z_matrix(C[None], t[None])[0]
