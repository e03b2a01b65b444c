"""The DCE tournament refine: CUDA kernels and dispatch.

The kernels (`csrc/dce_comp.cu`) replace both Pallas TPU kernels of
`repro/kernels/dce_comp/dce_comp.py` and their consumers:

  batched_z_matrix — the Z tiles, stored (`batched_z_matrix` directly,
      `z_matrix` as its B = 1 case), with the column tiles split over
      more blocks where the rows alone leave SMs idle (`z_plan`);
  refine_topk — the same main loop fused with the candidate gather, the
      win count and the top-k by wins (`search_engine.refine_candidates`
      with `ops.batched_top_k_by_wins`): two launches, a Z + win count
      and a per-query ranking, counted as one in `launches`.

For CUDA tensors the wrappers launch them (or raise); for CPU tensors
they run the plain versions beside them; for `meta` tensors they make
the outputs a launch would allocate.  The ciphertexts (C, C_dce) are
read in place as float32, bfloat16 or float16 (float64 is rounded to
float32) and T is made float32: the reference's kernels cast both to
float32, and 16-bit values are exact in it.
"""

from __future__ import annotations

import torch

from .. import _build
from ..common import float_operand, on_cpu, on_meta, row_operand
from .ref import batched_z_matrix as plain_batched_z_matrix
from .ref import refine_topk as plain_refine_topk

__all__ = ["batched_z_matrix", "z_matrix", "refine_topk", "z_plan",
           "plain_batched_z_matrix", "plain_z_matrix", "plain_refine_topk",
           "launches"]

# Kernel launches since import, per kernel (z_matrix counts under
# batched_z_matrix: it is the batched kernel with B = 1; a refine_topk
# call's two stages count as one); a caller auditing a run resets the
# counts to 0.
launches = {"batched_z_matrix": 0, "refine_topk": 0}

_MAX_BATCH = 65535          # one grid y-slice per query
_Z_ARGTYPES = [_build.PTR] * 3 + [_build.INT] * 7 + [_build.PTR]
# Mirrors csrc/dce_comp.cu: row and column thread groups, columns of a
# j-tile, the largest rows a thread.
_GROUPS, _TJ, _MAX_RI = 16, 80, 5
_SMS = 132                  # H100 SXM streaming multiprocessors
_REFINE_ARGTYPES = ([_build.PTR, _build.LONG] + [_build.PTR] * 5
                    + [_build.INT] * 6 + [_build.PTR])


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def z_plan(B: int, n: int, sms: int = _SMS):
    """The Z entry's block plan: (RI, splits).  The ceil(n / 80) j-tiles
    are cut into `splits` ranges over a third grid dimension, as many as
    still let B x ceil(n / 16 RI) x splits blocks fit the SMs once, with
    the smallest RI (rows a thread, 1..5) that does; where even one range
    does not fit, RI 5 and no split.  At n 512, B 1: RI 2 and 7 ranges, 112
    blocks (RI 1 and no split, the refine's rule, gives 32): each block
    walks all of D for its tile, so fewer, fuller blocks finish sooner."""
    for splits in range(-(-n // _TJ), 0, -1):
        for ri in range(1, _MAX_RI + 1):
            if B * -(-n // (_GROUPS * ri)) * splits <= sms:
                return ri, splits
    return _MAX_RI, 1


def batched_z_matrix(C: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Per-query all-pairs Z tensors for a batch of candidate sets.

    C: (B, n, 4, D) candidate ciphertexts, T: (B, D) trapdoors ->
    (B, n, n) float32.  CUDA tensors must be contiguous, C float32,
    bfloat16 or float16 (read in place), T any float (made float32); the
    output is allocated here and the kernel runs on the current stream
    without synchronizing."""
    meta = on_meta(C, T)
    if not meta and on_cpu(C, T):
        return plain_batched_z_matrix(C, T)
    if (C.dim() != 4 or C.shape[2] != 4 or T.dim() != 2
            or T.shape != (C.shape[0], C.shape[3])):
        raise ValueError(f"batched_z_matrix needs C (B, n, 4, D) and "
                         f"T (B, D), got {tuple(C.shape)} and "
                         f"{tuple(T.shape)}")
    C, code = row_operand(C, "dce_comp.batched_z_matrix's C")
    T = float_operand(T, "dce_comp.batched_z_matrix's T")
    if not (C.is_contiguous() and T.is_contiguous()):
        raise ValueError("the dce_comp kernels take contiguous C and T")
    B, n, _, D = C.shape
    if B > _MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's {_MAX_BATCH}")
    Z = torch.empty((B, n, n), dtype=torch.float32, device=C.device)
    if B == 0 or n == 0 or meta:
        return Z
    ri, splits = z_plan(B, n, torch.cuda.get_device_properties(
        C.device).multi_processor_count)
    fn = _build.function("repro_dce_batched_z", _Z_ARGTYPES)
    err = fn(C.data_ptr(), T.data_ptr(), Z.data_ptr(), B, n, D, ri, splits,
             code, C.device.index, _stream(C.device))
    _build.check(err, "dce_comp.batched_z_matrix")
    launches["batched_z_matrix"] += 1
    return Z


def z_matrix(C: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """All-pairs DCE Z-scores for one candidate set.  C: (n, 4, D),
    t: (D,) -> (n, n): the batched kernel with B = 1."""
    return batched_z_matrix(C[None], t[None])[0]


def plain_z_matrix(C: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return plain_batched_z_matrix(C[None], t[None])[0]


def refine_topk(C_dce: torch.Tensor, cand: torch.Tensor, T: torch.Tensor,
                valid: torch.Tensor | None, k: int, *,
                return_wins: bool = False):
    """Exact DCE tournament refine of per-query candidate sets, fused.

    C_dce: (N, 4, D) refine ciphertexts; cand: (B, n) int64 candidate ids
    (an invalid slot's id is never read); T: (B, D) trapdoors; valid:
    (B, n) bool, or None for all valid -> ids (B, k) int64 by descending
    win count (ascending true distance), ties to the lowest slot, -1
    where the selected slot is invalid; k = min(k, n).  A win of i over j
    is Z[b, i, j] < 0 with j != i and j valid; an invalid slot has -1
    wins.  With return_wins also the (B, n) int32 win counts.  CUDA
    tensors must be contiguous: C_dce float32, bfloat16 or float16 (read
    in place; float64 is rounded to float32: the win counts are those of
    a float32 copy), T any float (made float32), cand int64; the kernels
    run on the current stream without synchronizing."""
    tensors = (C_dce, cand, T) if valid is None else (C_dce, cand, T, valid)
    meta = on_meta(*tensors)
    if not meta and on_cpu(*tensors):
        return plain_refine_topk(C_dce, cand, T, valid, k,
                                 return_wins=return_wins)
    if (C_dce.dim() != 3 or C_dce.shape[1] != 4 or cand.dim() != 2
            or T.shape != (cand.shape[0], C_dce.shape[2])
            or (valid is not None and valid.shape != cand.shape)):
        raise ValueError(f"refine_topk needs C_dce (N, 4, D), cand (B, n), "
                         f"T (B, D) and valid (B, n) or None; got "
                         f"{tuple(C_dce.shape)}, {tuple(cand.shape)}, "
                         f"{tuple(T.shape)}, "
                         f"{None if valid is None else tuple(valid.shape)}")
    if cand.dtype != torch.int64 or (valid is not None
                                     and valid.dtype != torch.bool):
        raise TypeError(f"the fused refine takes int64 cand and bool valid; "
                        f"got {cand.dtype}, "
                        f"{None if valid is None else valid.dtype}")
    C_dce, code = row_operand(C_dce, "dce_comp.refine_topk's C_dce")
    T = float_operand(T, "dce_comp.refine_topk's T")
    tensors = (C_dce, cand, T) if valid is None else (C_dce, cand, T, valid)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the fused refine takes contiguous tensors")
    B, n = cand.shape
    if B > _MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's {_MAX_BATCH}")
    k = min(int(k), n)
    dev = C_dce.device
    out = torch.empty((B, max(k, 0)), dtype=torch.int64, device=dev)
    wins = torch.empty((B, n), dtype=torch.int32, device=dev)
    if k > 0 and B > 0 and not meta:
        fn = _build.function("repro_dce_refine_topk", _REFINE_ARGTYPES)
        vptr = 0 if valid is None else valid.view(torch.uint8).data_ptr()
        err = fn(C_dce.data_ptr(), C_dce.shape[0], cand.data_ptr(),
                 T.data_ptr(), vptr or None, wins.data_ptr(),
                 out.data_ptr(), B, n, C_dce.shape[2], k, code, dev.index,
                 _stream(dev))
        _build.check(err, "dce_comp.refine_topk")
        launches["refine_topk"] += 1
    return (out, wins) if return_wins else out
