"""The flat filter's scan: CUDA kernels and dispatch.

The kernels (`csrc/l2_topk.cu`) replace the Pallas TPU kernel
`repro/kernels/l2_topk/l2_topk.py :: pairwise_sq_dists` and the chunk
loop of its wrapper `repro/kernels/l2_topk/ops.py :: knn`:

  pairwise_sq_dists — the distance tiles, stored: (nq, n);
  knn — the same tiles fused with a per-query running top-k in shared
      memory: one call scans the whole database (two launches, a scan
      and a per-query merge, counted as one in `launches`); a k above
      MAX_KP runs in passes of at most MAX_KP, each counted.

knn's chunks of rows are the block plan of least makespan over the
card's slots (`common.block_plan`), cached per shape and device; while a
kernel profiler is active each pass adds the plan's work and slot tiles
to its counters.

For CUDA tensors the wrappers launch them (or raise); for CPU tensors
they run the plain versions beside them, `plain_pairwise_sq_dists` and
`plain_knn` (the chunked merge over plain tiles); for `meta` tensors
they make the outputs and buffers a launch would allocate.  X is read in
place as float32, bfloat16 or float16 (float64 is rounded to float32)
and Q is made float32: the reference's kernel casts both to float32, and
16-bit values are exact in it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..common import (block_plan, count_plan, float_operand, floor_passes,
                      on_cpu, on_meta, pass_sizes, row_operand)
from .ref import pairwise_sq_dists as plain_pairwise_sq_dists
from .ref import scan_knn as plain_knn

__all__ = ["pairwise_sq_dists", "knn", "plain_pairwise_sq_dists",
           "plain_knn", "MAX_KP", "launches"]

# Kernel launches since import, per kernel (a knn call's two stages count
# as one launch); a caller auditing a run resets the counts to 0.
launches = {"pairwise_sq_dists": 0, "knn": 0}

MAX_KP = 1024                   # the fused scan's largest top-k a pass
# Mirrors csrc/l2_topk.cu: rows of a block tile, which set how the rows
# are cut into chunks.
_ROWS = 512
_SHARED_LIMIT = 232448          # H100 opt-in shared memory per block
_SMS = 132                      # H100 SXM streaming multiprocessors
# A chunk's fixed cost in tile-times, the block plan's c (measured on the
# H100: csrc/l2_topk.cu's note).
_CHUNK_COST = 10.0

_TILE_ARGTYPES = [_build.PTR] * 3 + [_build.INT] * 5 + [_build.PTR]
_KNN_ARGTYPES = [_build.PTR] * 7 + [_build.INT] * 8 + [_build.PTR]


def _operands(Q: torch.Tensor, X: torch.Tensor, what: str):
    """Q and X as the kernels take them: X read in place (float32,
    bfloat16 or float16; float64 rounded), Q as float32 (the reference's
    `astype`; it is small).  -> (Q, X, X's element code)."""
    if Q.dim() != 2 or X.dim() != 2 or Q.shape[1] != X.shape[1]:
        raise ValueError(f"{what} needs (nq, d) and (n, d), "
                         f"got {tuple(Q.shape)} and {tuple(X.shape)}")
    X, code = row_operand(X, f"l2_topk.{what}'s X")
    Q = float_operand(Q, f"l2_topk.{what}'s Q")
    if not (Q.is_contiguous() and X.is_contiguous()):
        raise ValueError("the l2 kernels take contiguous Q and X")
    return Q, X, code


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def pairwise_sq_dists(Q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """All-pairs ||q - x||^2.  Q: (nq, d), X: (n, d) -> (nq, n) float32.

    CUDA tensors must be contiguous (row-major); X float32, bfloat16 or
    float16 (read in place; float64 is rounded to float32), Q any float
    (made float32).  The output is allocated here and the kernel runs on
    the current stream without synchronizing; `meta` tensors give the
    output alone."""
    if not on_meta(Q, X) and on_cpu(Q, X):
        return plain_pairwise_sq_dists(Q, X)
    Q, X, code = _operands(Q, X, "pairwise_sq_dists")
    nq, d = Q.shape
    n = X.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=Q.device)
    if on_meta(Q, X):
        return out
    fn = _build.function("repro_l2_sq_dists", _TILE_ARGTYPES)
    err = fn(Q.data_ptr(), X.data_ptr(), out.data_ptr(), nq, n, d, code,
             Q.device.index, _stream(Q.device))
    _build.check(err, "l2_topk.pairwise_sq_dists")
    launches["pairwise_sq_dists"] += 1
    return out


@functools.lru_cache(maxsize=1024)
def _plan(nq: int, n: int, k: int, code: int, dev, floor: bool = False):
    """Check a pass's k and the shared memory a block needs; plan the
    blocks over the card's slots, its SMs x the blocks of the launched
    variant (`code`: the rows' element type; `floor`: a later pass) one
    SM holds.  Cached per shape and device, so a batch adds no host work.
    -> common.BlockPlan."""
    if k > MAX_KP:
        raise ValueError(f"k={k} exceeds the fused l2 scan's limit of "
                         f"{MAX_KP} a pass")
    smem_fn = _build.function("repro_l2_knn_smem", [_build.INT] * 2)
    smem_fn.restype = ctypes.c_longlong
    need = smem_fn(k, code)
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin", _SHARED_LIMIT)
    if need > limit:
        raise ValueError(f"the fused l2 scan needs {need} bytes of shared "
                         f"memory a block at k={k}; the card has {limit}")
    qb = _build.function("repro_l2_knn_queries_per_block", [_build.INT])(k)
    resident = _build.function("repro_l2_knn_blocks_per_sm",
                               [_build.INT] * 4)(
        k, code, int(floor), getattr(dev, "index", 0))
    if resident < 1:
        raise RuntimeError(f"l2_topk.knn: no block fits an SM at k={k} "
                           f"({resident})")
    return _chunks(nq, n, qb, props.multi_processor_count * resident)


def _chunks(nq: int, n: int, qb: int, slots: int):
    """The block plan over the ceil(nq / qb) query groups and the rows in
    tiles of _ROWS, `slots` blocks at once (`common.block_plan`)."""
    return block_plan(-(-nq // qb), n, _ROWS, slots, _CHUNK_COST)


def _meta_knn(Q: torch.Tensor, X: torch.Tensor, k: int):
    """knn on `meta` tensors: each pass's outputs and its (nq, G, kp)
    partial-result buffer, as the card allocates them (queries a block
    as csrc/l2_topk.cu's queries_per_block, the H100's SMs at one block
    each, as the variants measured there run)."""
    nq, n = Q.shape[0], X.shape[0]
    k = min(int(k), n)
    if k <= 0 or nq == 0:
        return (torch.empty((nq, max(k, 0)), dtype=torch.float32,
                            device="meta"),
                torch.empty((nq, max(k, 0)), dtype=torch.int64,
                            device="meta"))
    dists, ids = [], []
    for kp in pass_sizes(k, MAX_KP):
        G = _chunks(nq, n, 32 if kp <= 256 else 8, _SMS).G
        part = torch.empty((nq, G, kp), dtype=torch.int64, device="meta")
        dists.append(torch.empty((nq, kp), dtype=torch.float32,
                                 device="meta"))
        ids.append(torch.empty((nq, kp), dtype=torch.int64, device="meta"))
        del part
    if len(dists) == 1:
        return dists[0], ids[0]
    return torch.cat(dists, 1), torch.cat(ids, 1)


def _launch(Q, X, out_d, out_i, floor_in, floor_out, kp: int,
            chunk_rows: int, G: int, code: int):
    """One pass of the fused scan on the card with the block plan given:
    the rows in G chunks of chunk_rows (whole tiles), one block per
    (query group, chunk), then the per-query merge; counted in
    `launches`."""
    nq, d = Q.shape
    dev = Q.device
    part = torch.empty((nq, G, kp), dtype=torch.int64, device=dev)
    fn = _build.function("repro_l2_knn", _KNN_ARGTYPES)
    err = fn(Q.data_ptr(), X.data_ptr(), part.data_ptr(), out_d.data_ptr(),
             out_i.data_ptr(),
             None if floor_in is None else floor_in.data_ptr(),
             None if floor_out is None else floor_out.data_ptr(), nq,
             X.shape[0], d, kp, chunk_rows, G, code, dev.index, _stream(dev))
    _build.check(err, "l2_topk.knn")
    launches["knn"] += 1


def knn(Q: torch.Tensor, X: torch.Tensor, k: int, *, chunk: int = 4096):
    """Exact k-NN of each query against X, in one scan (a pass of at most
    MAX_KP each for a larger k: `common.floor_passes`).

    Q: (nq, d), X: (n, d)  ->  (dists (nq, k) float32 ascending, ids
    (nq, k) int64), ties to the lowest id; k = min(k, n).  Distances are
    ||q||^2 - 2 q.x + ||x||^2 in true fp32.  CUDA tensors must be
    contiguous; X float32, bfloat16 or float16, read in place (its values
    are exact in float32, so the ids and distances are those of a float32
    copy; float64 is rounded to float32), Q any float (made float32).
    The kernels run on the current stream without synchronizing.  `chunk`
    is the plain version's block of rows (CPU tensors only)."""
    if on_meta(Q, X):
        Q, X, _ = _operands(Q, X, "knn")
        return _meta_knn(Q, X, k)
    if on_cpu(Q, X):
        return plain_knn(Q, X, k, chunk=chunk)
    Q, X, code = _operands(Q, X, "knn")
    nq, d = Q.shape
    n = X.shape[0]
    k = min(int(k), n)
    dev = Q.device
    if k <= 0 or nq == 0:
        return (torch.empty((nq, max(k, 0)), dtype=torch.float32, device=dev),
                torch.empty((nq, max(k, 0)), dtype=torch.int64, device=dev))

    def one_pass(kp, floor_in, floor_out):
        out_d = torch.empty((nq, kp), dtype=torch.float32, device=dev)
        out_i = torch.empty((nq, kp), dtype=torch.int64, device=dev)
        plan = _plan(nq, n, kp, code, dev, floor_in is not None)
        _launch(Q, X, out_d, out_i, floor_in, floor_out, kp, plan.chunk_rows,
                plan.G, code)
        count_plan("l2_topk.knn", plan)
        return out_d, out_i

    return floor_passes(k, MAX_KP, nq, one_pass, float("inf"), dev)
