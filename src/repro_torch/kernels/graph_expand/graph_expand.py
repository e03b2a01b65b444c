"""The batched HNSW graph walk: CUDA kernel and dispatch.

The kernel (`csrc/graph_expand.cu`) replaces the Pallas TPU kernel
`repro/kernels/graph_expand/graph_expand.py :: expand_layer0` and, for
the f32 perf walk, the reference's XLA upper-layer descent
`repro/graph/traverse.py :: upper_entry`.  One warp walks one query.  Two
entries launch it:

  graph_walk — the whole walk from the graph's entry point (upper-layer
      greedy descent, then the layer-0 beam search): one launch a batch;
      plain version `graph.traverse.traverse`;
  expand_layer0 — the layer-0 beam search alone, from given descent
      endpoints; plain version `ref.beam_layer0`.

For CUDA tensors the wrappers launch the kernel (or raise); for CPU
tensors they run the plain versions; for `meta` tensors they make the
outputs a launch would allocate.  C is read in place as float32,
bfloat16 or float16 (float64 is rounded to float32), Q is made float32:
the reference's kernel casts both to float32, and 16-bit values are
exact in it.  `walk_plan` picks the kernel's variant: the visited bitmap
in shared memory where R allows, the adjacency pool where it fits, then
the point rows staged a group.
"""

from __future__ import annotations

import ctypes

import torch

from ...graph import traverse as _traverse
from .. import _build
from ..common import float_operand, on_cpu, on_meta, row_operand
from . import ref as _ref

__all__ = ["graph_walk", "expand_layer0", "plain_graph_walk",
           "plain_expand_layer0", "unpack_visited", "walk_plan",
           "walk_smem", "launches"]

# Kernel launches since import, per entry; a caller auditing a run resets
# the counts to 0.
launches = {"graph_walk": 0, "expand_layer0": 0}

SVIS_MAX_R = 2 ** 20            # the largest R whose bitmap goes on chip
MAX_GROUP = 32                  # point rows staged a group: one per lane
_SHARED_LIMIT = 232448          # H100 opt-in shared memory per block

_WALK_ARGTYPES = [_build.PTR] * 10 + [_build.INT] * 15 + [_build.PTR]
_LAYER0_ARGTYPES = [_build.PTR] * 11 + [_build.INT] * 12 + [_build.PTR]


def _up16(x: int) -> int:
    return (x + 15) & ~15


def walk_smem(ef: int, M0: int, M: int, d: int, G: int, pool: bool,
              svis: bool, R: int) -> int:
    """Shared memory (bytes) of a query's block: mirrors `layout` in
    csrc/graph_expand.cu (the card's `repro_graph_walk_smem`)."""
    dpad = (d + 3) & ~3
    mm = max(M0, M)
    pr = (M0 + 3) & ~3
    sizes = [8, 4 * dpad, 4 * G * (dpad + 32), 8 * ef, 8 * ef, 8 * ef, 2 * ef,
             4 * mm, 4 * mm, 4 * mm, 4 * mm, 4 * mm, 4 * mm, 8 * M0,
             4 * (ef + M0) * pr if pool else 0,
             4 * ((R + 31) // 32) if svis else 0]
    total = 0
    for s in sizes:
        total = _up16(total + s)
    return total


def walk_plan(R: int, M0: int, M: int, d: int, ef: int,
              limit: int = _SHARED_LIMIT):
    """The kernel's variant for these shapes: (G, pool, svis).

    The largest group G of point rows (<= 32, <= max(M0, M)) first, as
    each further group is one more device-memory round trip a hop; then
    the visited bitmap in shared memory (only where R <= SVIS_MAX_R);
    then the adjacency pool.  Raises if no variant fits the card's
    per-block limit."""
    svis_options = (True, False) if R <= SVIS_MAX_R else (False,)
    for G in range(min(MAX_GROUP, max(M0, M)), 0, -1):
        for svis in svis_options:
            for pool in (True, False):
                if walk_smem(ef, M0, M, d, G, pool, svis, R) <= limit:
                    return G, pool, svis
    raise ValueError(f"the graph walk kernel does not fit {limit} bytes of "
                     f"shared memory at ef={ef}, M0={M0}, M={M}, d={d}")


def unpack_visited(words: torch.Tensor, R: int) -> torch.Tensor:
    """(nq, ceil(R/32)) packed words (bit b of word w is row 32w + b)
    -> the (nq, R) bool scan trace."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :R].bool()


def plain_expand_layer0(neigh0, ok, C, Q, ep, ep_d, ef: int, *,
                        ef_cap: int, max_hops: int):
    """expand_layer0's function in plain PyTorch (any device)."""
    return _ref.beam_layer0(neigh0, ok, (C,), Q, ep, ep_d, ef,
                            kp=ef_cap, ef_cap=ef_cap, max_hops=max_hops)


def plain_graph_walk(neigh0, neigh_up, ok, C, Q, entry: int, ef: int, *,
                     ef_cap: int, max_hops: int):
    """graph_walk's function in plain PyTorch (any device): the torch
    walk with the whole beam kept."""
    return _traverse.traverse(neigh0, neigh_up, ok, (C,), Q, entry, ef,
                              kp=ef_cap, ef_cap=ef_cap, max_hops=max_hops)


def _check(neigh0, ok, C, Q, ef: int, ef_cap: int, max_hops: int,
           what: str):
    """The operands as the kernel takes them: -> (C read in place, its
    element code, Q as float32)."""
    if (neigh0.dim() != 2 or C.dim() != 2 or Q.dim() != 2
            or C.shape[0] != neigh0.shape[0] or ok.shape != (C.shape[0],)
            or Q.shape[1] != C.shape[1]):
        raise ValueError(
            f"{what} needs neigh0 (R, M0), ok (R,), C (R, d), Q (nq, d); "
            f"got {tuple(neigh0.shape)}, {tuple(ok.shape)}, "
            f"{tuple(C.shape)}, {tuple(Q.shape)}")
    if neigh0.dtype != torch.int32 or ok.dtype != torch.bool:
        raise TypeError(f"the graph walk kernel takes int32 neigh0 and "
                        f"bool ok; got {neigh0.dtype}, {ok.dtype}")
    C, code = row_operand(C, f"graph_expand.{what}'s C")
    Q = float_operand(Q, f"graph_expand.{what}'s Q")
    if not all(t.is_contiguous() for t in (neigh0, ok, C, Q)):
        raise ValueError("the graph walk kernel takes contiguous "
                         "neigh0, ok, C and Q")
    if not 1 <= ef <= ef_cap or max_hops < 0:
        raise ValueError(f"need 1 <= ef={ef} <= ef_cap={ef_cap} and "
                         f"max_hops={max_hops} >= 0")
    return C, code, Q


def _outputs(nq: int, R: int, ef_cap: int, dev):
    return (torch.empty((nq, ef_cap), dtype=torch.int32, device=dev),
            torch.empty((nq, ef_cap), dtype=torch.float32, device=dev),
            torch.empty((nq, (R + 31) // 32), dtype=torch.int32, device=dev),
            torch.empty(nq, dtype=torch.int32, device=dev),
            torch.empty(nq, dtype=torch.int32, device=dev))


def _limit(dev) -> int:
    if dev.type == "meta":
        return _SHARED_LIMIT
    props = torch.cuda.get_device_properties(dev)
    return getattr(props, "shared_memory_per_block_optin", _SHARED_LIMIT)


def graph_walk(neigh0: torch.Tensor, neigh_up: torch.Tensor,
               ok: torch.Tensor, C: torch.Tensor, Q: torch.Tensor,
               entry: int, ef: int, *, ef_cap: int, max_hops: int):
    """The batched f32 graph walk of `graph.traverse.traverse`, whole.

    neigh0 (R, M0) / neigh_up (LU, R, M) int32, -1 padded; ok (R,) bool;
    C (R, d) float32, bfloat16 or float16 (read in place; float64 is
    rounded to float32); Q (nq, d) any float (made float32); entry the
    graph's entry point (-1: empty); ef the effective beam width.  Returns
    (beam_i (nq, ef_cap) int32 -1 fill, beam_d (nq, ef_cap) float32 +inf
    fill, visited (nq, R) bool, hops (nq,) int32, edges (nq,) int32), the
    upper layers' hops and edges included.  CUDA tensors must have those
    dtypes and be contiguous; the kernel runs on the current stream
    without synchronizing."""
    meta = on_meta(neigh0, neigh_up, ok, C, Q)
    if not meta and on_cpu(neigh0, neigh_up, ok, C, Q):
        return plain_graph_walk(neigh0, neigh_up, ok, C, Q, entry, ef,
                                ef_cap=ef_cap, max_hops=max_hops)
    C, code, Q = _check(neigh0, ok, C, Q, ef, ef_cap, max_hops,
                        "graph_walk")
    if (neigh_up.dim() != 3 or neigh_up.shape[1] != neigh0.shape[0]
            or neigh_up.dtype != torch.int32
            or not neigh_up.is_contiguous()):
        raise ValueError(f"graph_walk needs a contiguous int32 neigh_up "
                         f"(LU, R, M); got {tuple(neigh_up.shape)} "
                         f"{neigh_up.dtype}")
    nq, d = Q.shape
    R, M0 = neigh0.shape
    LU, _, M = neigh_up.shape
    dev = Q.device
    G, pool, svis = walk_plan(R, M0, M if LU else 0, d, ef, _limit(dev))
    beam_i, beam_d, words, hops, edges = _outputs(nq, R, ef_cap, dev)
    if meta:
        return beam_i, beam_d, unpack_visited(words, R), hops, edges
    fn = _build.function("repro_graph_walk", _WALK_ARGTYPES)
    err = fn(neigh0.data_ptr(), neigh_up.data_ptr() if LU else None,
             ok.data_ptr(), C.data_ptr(), Q.data_ptr(), beam_i.data_ptr(),
             beam_d.data_ptr(), words.data_ptr(), hops.data_ptr(),
             edges.data_ptr(), nq, R, M0, M if LU else 0, LU, d,
             int(entry), int(ef), ef_cap, max_hops, G, int(pool),
             int(svis), code, dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "graph_expand.graph_walk")
    launches["graph_walk"] += 1
    return beam_i, beam_d, unpack_visited(words, R), hops, edges


def expand_layer0(neigh0: torch.Tensor, ok: torch.Tensor, C: torch.Tensor,
                  Q: torch.Tensor, ep: torch.Tensor, ep_d: torch.Tensor,
                  ef: int, *, ef_cap: int, max_hops: int):
    """Batched layer-0 beam search (f32 scoring) from given endpoints.

    neigh0 (R, M0) int32 (-1 padded); ok (R,) bool row validity; C (R, d)
    float32, bfloat16 or float16 (read in place; float64 is rounded to
    float32); Q (nq, d) any float (made float32); ep/ep_d (nq,) the
    upper-layer descent endpoints (ep -1: empty graph); ef the effective
    beam width.
    Returns (beam_i (nq, ef_cap) int32, beam_d (nq, ef_cap) float32,
    visited (nq, R) bool, hops (nq,) int32, edges (nq,) int32): the
    contract of `ref.beam_layer0` before the kp slice, with the layer-0
    hops and edges only.

    CUDA tensors: neigh0, ok, C and Q must have those dtypes and be
    contiguous (no copy of the large arrays is made); the kernel runs on
    the current stream without synchronizing."""
    meta = on_meta(neigh0, ok, C, Q, ep, ep_d)
    if not meta and on_cpu(neigh0, ok, C, Q, ep, ep_d):
        return plain_expand_layer0(neigh0, ok, C, Q, ep, ep_d, ef,
                                   ef_cap=ef_cap, max_hops=max_hops)
    C, code, Q = _check(neigh0, ok, C, Q, ef, ef_cap, max_hops,
                        "expand_layer0")
    if ep.shape != (Q.shape[0],) or ep_d.shape != (Q.shape[0],):
        raise ValueError(f"expand_layer0 needs ep and ep_d (nq,); got "
                         f"{tuple(ep.shape)}, {tuple(ep_d.shape)}")
    nq, d = Q.shape
    R, M0 = neigh0.shape
    dev = Q.device
    G, pool, svis = walk_plan(R, M0, 0, d, ef, _limit(dev))
    ep = ep.to(torch.int32).contiguous()
    ep_d = ep_d.to(torch.float32).contiguous()
    beam_i, beam_d, words, hops, edges = _outputs(nq, R, ef_cap, dev)
    if meta:
        return beam_i, beam_d, unpack_visited(words, R), hops, edges
    fn = _build.function("repro_graph_expand_layer0", _LAYER0_ARGTYPES)
    err = fn(neigh0.data_ptr(), ok.data_ptr(), C.data_ptr(), Q.data_ptr(),
             ep.data_ptr(), ep_d.data_ptr(), beam_i.data_ptr(),
             beam_d.data_ptr(), words.data_ptr(), hops.data_ptr(),
             edges.data_ptr(), nq, R, M0, d, int(ef), ef_cap, max_hops, G,
             int(pool), int(svis), code, dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "graph_expand.expand_layer0")
    launches["expand_layer0"] += 1
    return beam_i, beam_d, unpack_visited(words, R), hops, edges


def walk_smem_on_card(ef: int, M0: int, M: int, d: int, G: int, pool: bool,
                      svis: bool, R: int) -> int:
    """The card library's own count of `walk_smem` (to hold the two
    against each other)."""
    fn = _build.function("repro_graph_walk_smem", [_build.INT] * 8)
    fn.restype = ctypes.c_longlong
    return fn(ef, M0, M, d, G, int(pool), int(svis), R)
