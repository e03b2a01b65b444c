"""Layer-0 beam search of the graph filter: CUDA kernel and dispatch.

The kernel (`csrc/graph_expand.cu`) replaces the Pallas TPU kernel
`repro/kernels/graph_expand/graph_expand.py :: expand_layer0`.  For CUDA
tensors the wrapper launches it (or raises); for CPU tensors it runs the
plain version, `ref.beam_layer0` with the whole beam kept.
"""

from __future__ import annotations

import torch

from .. import _build
from ..common import on_cpu
from . import ref as _ref

__all__ = ["expand_layer0", "plain_expand_layer0", "unpack_visited",
           "launches"]

# Kernel launches since import; a caller auditing a run resets it to 0.
launches = 0

_ARGTYPES = [_build.PTR] * 11 + [_build.INT] * 8 + [_build.PTR]


def plain_expand_layer0(neigh0, ok, C, Q, ep, ep_d, ef: int, *,
                        ef_cap: int, max_hops: int):
    """The kernel's function in plain PyTorch (any device)."""
    return _ref.beam_layer0(neigh0, ok, (C,), Q, ep, ep_d, ef,
                                 kp=ef_cap, ef_cap=ef_cap,
                                 max_hops=max_hops)


def unpack_visited(words: torch.Tensor, R: int) -> torch.Tensor:
    """(nq, ceil(R/32)) packed words (bit b of word w is row 32w + b)
    -> the (nq, R) bool scan trace."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :R].bool()


def expand_layer0(neigh0: torch.Tensor, ok: torch.Tensor, C: torch.Tensor,
                  Q: torch.Tensor, ep: torch.Tensor, ep_d: torch.Tensor,
                  ef: int, *, ef_cap: int, max_hops: int):
    """Batched layer-0 beam search (f32 scoring).

    neigh0 (R, M0) int32 (-1 padded); ok (R,) bool row validity; C (R, d)
    float32; Q (nq, d) float32; ep/ep_d (nq,) the upper-layer descent
    endpoints (ep -1: empty graph); ef the effective beam width.
    Returns (beam_i (nq, ef_cap) int32, beam_d (nq, ef_cap) float32,
    visited (nq, R) bool, hops (nq,) int32, edges (nq,) int32): the
    contract of `ref.beam_layer0` before the kp slice, with
    the layer-0 hops and edges only.

    CUDA tensors: neigh0, ok, C and Q must have those dtypes and be
    contiguous (no copy of the large arrays is made); the kernel runs on
    the current stream without synchronizing."""
    global launches
    if on_cpu(neigh0, ok, C, Q, ep, ep_d):
        return plain_expand_layer0(neigh0, ok, C, Q, ep, ep_d, ef,
                                   ef_cap=ef_cap, max_hops=max_hops)
    if (neigh0.dim() != 2 or C.dim() != 2 or Q.dim() != 2
            or C.shape[0] != neigh0.shape[0] or ok.shape != (C.shape[0],)
            or Q.shape[1] != C.shape[1]
            or ep.shape != (Q.shape[0],) or ep_d.shape != (Q.shape[0],)):
        raise ValueError(
            f"expand_layer0 needs neigh0 (R, M0), ok (R,), C (R, d), "
            f"Q (nq, d), ep and ep_d (nq,); got {tuple(neigh0.shape)}, "
            f"{tuple(ok.shape)}, {tuple(C.shape)}, {tuple(Q.shape)}, "
            f"{tuple(ep.shape)}, {tuple(ep_d.shape)}")
    if (neigh0.dtype != torch.int32 or ok.dtype != torch.bool
            or C.dtype != torch.float32 or Q.dtype != torch.float32):
        raise TypeError(f"the graph_expand kernel takes int32 neigh0, bool "
                        f"ok, float32 C and Q; got {neigh0.dtype}, "
                        f"{ok.dtype}, {C.dtype}, {Q.dtype}")
    if not all(t.is_contiguous() for t in (neigh0, ok, C, Q)):
        raise ValueError("the graph_expand kernel takes contiguous "
                         "neigh0, ok, C and Q")
    if not 1 <= ef <= ef_cap or max_hops < 0:
        raise ValueError(f"need 1 <= ef={ef} <= ef_cap={ef_cap} and "
                         f"max_hops={max_hops} >= 0")
    nq, d = Q.shape
    R, M0 = neigh0.shape
    dev = Q.device
    ep = ep.to(torch.int32).contiguous()
    ep_d = ep_d.to(torch.float32).contiguous()
    beam_i = torch.empty((nq, ef_cap), dtype=torch.int32, device=dev)
    beam_d = torch.empty((nq, ef_cap), dtype=torch.float32, device=dev)
    words = torch.empty((nq, (R + 31) // 32), dtype=torch.int32, device=dev)
    hops = torch.empty(nq, dtype=torch.int32, device=dev)
    edges = torch.empty(nq, dtype=torch.int32, device=dev)
    fn = _build.function("repro_graph_expand_layer0", _ARGTYPES)
    err = fn(neigh0.data_ptr(), ok.data_ptr(), C.data_ptr(), Q.data_ptr(),
             ep.data_ptr(), ep_d.data_ptr(), beam_i.data_ptr(),
             beam_d.data_ptr(), words.data_ptr(), hops.data_ptr(),
             edges.data_ptr(), nq, R, M0, d, int(ef), ef_cap, max_hops,
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "graph_expand.expand_layer0")
    launches += 1
    return beam_i, beam_d, unpack_visited(words, R), hops, edges
