"""Fused quantized-ADC scan + top-kp: CUDA kernels and dispatch.

The kernels (`csrc/adc_topk.cu`) replace the Pallas TPU kernels
`repro/kernels/adc_topk/adc_topk.py :: sq_adc_topk` (int8) and
`:: pq_adc_topk` (PQ).  For CUDA tensors the wrappers launch them (or
raise); for CPU tensors they run the plain versions beside them,
`plain_sq_adc_topk` and `plain_pq_adc_topk`.  Each call is two launches
from the same source and counts as one in `launches`:

  sq_adc_topk: a grid of (query groups of 32, or 16 where kp > 256) x
      (row chunks of a multiple of 256 rows); each block streams its
      chunk's codes once through the tensor cores (int8 mma, int32 sums)
      and keeps a running top-kp per query; then one block per query
      merges the chunks' partial lists;
  pq_adc_topk: a grid of (query groups of QB = 8, 4, 2 or 1, the largest
      whose tables fit in shared memory) x (row chunks of a multiple of
      1024 rows); each block holds its queries' tables interleaved as
      [j][code][q] and sums 4 or 8 rows a lane; then the same merge.

The chunks are the block plan of least makespan over the card's slots
(`common.block_plan`), cached per shape and device; while a kernel
profiler is active each launch adds the plan's work and slot tiles to
its counters.

K4 takes one of two routes, chosen from the shape (`sq_route`): the TMA
route where the rows span more than one tile, the codes allow a tensor
map (d % 16 == 0, 16-byte aligned) and its ring fits beside the
selection (queries in registers where they fit, else in shared memory;
4, 3 or 2 ring stages), else the byte-staging route.  Either route's
slots are the card's SMs x the blocks of its variant one SM holds, its
chunk cost its own.

A kp above MAX_KP runs in passes of at most MAX_KP (`common.floor_passes`:
each pass offers only the keys after its query's last key of the pass
before), each pass counted in `launches`.  The small operands are
converted as the reference's `astype` converts them: K4's `cn` of any
integer dtype to int32, K5's tables of any float dtype to float32.  For
`meta` tensors the wrappers make the outputs a launch would allocate.

K4's query operand is made on the card too: `sq_encode_queries`
quantizes the float32 queries on the codebook's grid in one launch
(`csrc/adc_topk.cu`'s `sq_encode_kernel`), the codes numpy's
`SQCodebook.encode_query` gives, bit for bit; CPU tensors run its plain
version.  While a kernel profiler is active each call adds the rows it
quantized to its counters, `card_rows` or `host_rows`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...obs.profiler import active_profiler
from .. import _build
from ..common import (block_plan, count_plan, float_operand, floor_passes,
                      int_operand, on_cpu, on_meta)
from .ref import INT_BIG
from .ref import pq_adc_topk as plain_pq_adc_topk
from .ref import sq_adc_topk as plain_sq_adc_topk
from .ref import sq_encode_queries as plain_sq_encode_queries

__all__ = ["sq_adc_topk", "pq_adc_topk", "sq_encode_queries",
           "plain_sq_adc_topk", "plain_pq_adc_topk",
           "plain_sq_encode_queries", "INT_BIG", "MAX_KP", "launches"]

# Kernel launches since import, per kernel (a call's two stages count as
# one launch); a caller auditing a run resets the counts to 0.
launches = {"sq_adc_topk": 0, "pq_adc_topk": 0, "sq_encode_queries": 0}

MAX_KP = 1024                   # the kernels' largest top-kp a pass
MAX_D = 2048                    # the int8 kernel's widest row
PQ_K = 256
# Mirrors csrc/adc_topk.cu: rows of a block's tile (chunks are whole
# tiles), and the queries a block scans together.
_TILE = {"sq": 256, "pq": 1024}
_PQ_QUERIES_PER_BLOCK = (8, 4, 2, 1)     # the first whose tables fit
_SHARED_LIMIT = 232448          # H100 opt-in shared memory per block
# A chunk's fixed cost in tile-times, the block plan's c (measured on the
# H100: csrc/adc_topk.cu's note): K4 on its byte-staging and TMA routes, K5.
_CHUNK_COST = {"sq": 30.0, "sq_tma": 74.0, "pq": 11.0}

_SQ_ARGTYPES = ([_build.PTR] * 9 + [_build.INT] * 6 + [_build.PTR]
                + [_build.INT] * 3 + [_build.PTR])
_PQ_ARGTYPES = [_build.PTR] * 8 + [_build.INT] * 8 + [_build.PTR]
_ENC_ARGTYPES = ([_build.PTR] * 2 + [ctypes.c_float, _build.PTR]
                 + [_build.INT] * 3 + [_build.PTR])
# Mirrors csrc/adc_topk.cu's TMA route: depth bytes a stage, query A
# fragment registers a lane at most, the ring stages tried (the most that
# fit).
_SQ_SLICE = 128
_SQ_QREGS = 32
_SQ_STAGES = (4, 3, 2)


class SqRoute(NamedTuple):
    """How a K4 pass runs: code tiles by TMA (`tma`) or by byte staging;
    on the TMA route the query fragments in registers (`qreg`) or in
    shared memory, and the ring's `stages` (0 on the staging route)."""
    tma: bool
    qreg: bool
    stages: int


def sq_queries_per_block(kp: int) -> int:
    """Queries a K4 block scans together: 32, or 16 where kp > 256 needs
    the shared memory for the selection state."""
    return 32 if kp <= 256 else 16


def sq_queries_in_registers(qb: int, d: int) -> bool:
    """The TMA route keeps a block's query A fragments in registers where
    they take at most 32 a lane (16 per 16 queries and 128-byte slice:
    d <= 128 at 32 queries, d <= 256 at 16), else in shared memory."""
    return (qb // 16) * -(-d // _SQ_SLICE) * 16 <= _SQ_QREGS


def sq_route(n: int, d: int, kp: int, aligned: bool, smem_of,
             limit: int) -> SqRoute:
    """The route of a K4 pass over n rows at d and kp: TMA where the rows
    span more than one tile (one tile has nothing to overlap with its
    copy), d % 16 == 0, the codes are 16-byte `aligned` (a tensor map's
    rows) and a ring of 4, 3 or 2 stages fits the card's `limit` beside
    the selection (`smem_of(qb, kp, d, qreg, stages)`: csrc's
    repro_sq_tma_smem_bytes), the most that fit; else byte staging."""
    qb = sq_queries_per_block(kp)
    if n > _TILE["sq"] and aligned and d % 16 == 0:
        qreg = sq_queries_in_registers(qb, d)
        for stages in _SQ_STAGES:
            if smem_of(qb, kp, d, int(qreg), stages) <= limit:
                return SqRoute(True, qreg, stages)
    return SqRoute(False, False, 0)


def _row_validity(ok: torch.Tensor, n: int) -> torch.Tensor:
    """ok as the kernels read it: (n,) uint8, 0 = row masked."""
    if ok.shape != (n,):
        raise ValueError(f"ok must be ({n},), got {tuple(ok.shape)}")
    valid = ok if ok.dtype == torch.bool else ok != 0
    return valid.contiguous().view(torch.uint8)


def _smem_limit(dev) -> tuple:
    props = torch.cuda.get_device_properties(dev)
    return props, getattr(props, "shared_memory_per_block_optin",
                          _SHARED_LIMIT)


def _smem_entry(name: str, nargs: int):
    fn = _build.function(name, [_build.INT] * nargs)
    fn.restype = ctypes.c_longlong
    return fn


@functools.lru_cache(maxsize=1024)
def _layout(kind: str, width: int, nq: int, n: int, kp: int, dev,
            floor: bool = False):
    """Check a pass's kp; take the queries a block (for K5 the largest
    that fits the card's shared memory, refusing an m where one query's
    tables do not); plan the blocks over the card's slots, its SMs x the
    blocks of the launched variant (`floor`: a later pass) one SM holds
    (K4: `_sq_layout`'s plan, of the route it takes).
    Cached per shape and device, so a batch adds no host work.  Returns
    (queries a block, common.BlockPlan)."""
    if kind == "sq":
        return _sq_layout(width, nq, n, kp, dev, floor)[:2]
    if kp > MAX_KP:
        raise ValueError(f"kp={kp} exceeds the adc_topk kernels' limit of "
                         f"{MAX_KP} a pass")
    props, limit = _smem_limit(dev)
    smem_fn = _smem_entry("repro_adc_smem_bytes", 4)
    for qb in _PQ_QUERIES_PER_BLOCK:
        need = smem_fn(1, qb, kp, width)
        if need <= limit:
            break
    else:
        raise ValueError(f"the pq_adc_topk kernel needs {need} bytes of "
                         f"shared memory a block at m={width}, "
                         f"kp={kp}; the card has {limit}")
    return qb, block_plan(-(-nq // qb), n, _TILE[kind],
                          props.multi_processor_count
                          * _resident(1, qb, kp, width, floor, dev, kind),
                          _CHUNK_COST[kind])


def _device_index(dev) -> int:
    index = getattr(dev, "index", 0)
    return torch.cuda.current_device() if index is None else index


def _resident(pq: int, qb: int, kp: int, width: int, floor: bool, dev,
              kind: str, route: SqRoute = SqRoute(False, False, 0)) -> int:
    """Blocks of the launched variant one SM holds (K4: of its `route`;
    repro_adc_blocks_per_sm)."""
    resident = _build.function("repro_adc_blocks_per_sm", [_build.INT] * 8)(
        pq, qb, kp, width, int(floor), int(route.qreg), route.stages,
        _device_index(dev))
    if resident < 1:
        raise RuntimeError(f"adc_topk.{kind}_adc_topk: no block fits an SM "
                           f"at kp={kp} ({resident})")
    return resident


@functools.lru_cache(maxsize=1024)
def _sq_layout(d: int, nq: int, n: int, kp: int, dev, floor: bool = False,
               aligned: bool = True):
    """K4's pass at this shape (`aligned`: the codes 16-byte aligned):
    its route (`sq_route`), and its block plan over SMs x the blocks of the
    route's variant one SM holds, at the route's chunk cost.  Cached per
    shape and device.  -> (queries a block, common.BlockPlan, SqRoute)."""
    if kp > MAX_KP:
        raise ValueError(f"kp={kp} exceeds the adc_topk kernels' limit of "
                         f"{MAX_KP} a pass")
    qb = sq_queries_per_block(kp)
    props, limit = _smem_limit(dev)
    route = sq_route(n, d, kp, aligned,
                     _smem_entry("repro_sq_tma_smem_bytes", 5), limit)
    if not route.tma:
        need = _smem_entry("repro_adc_smem_bytes", 4)(0, qb, kp, d)
        if need > limit:
            raise ValueError(f"the sq_adc_topk kernel needs {need} bytes of "
                             f"shared memory a block at d={d}, kp={kp}; the "
                             f"card has {limit}")
    return qb, block_plan(-(-nq // qb), n, _TILE["sq"],
                          props.multi_processor_count
                          * _resident(0, qb, kp, d, floor, dev, "sq", route),
                          _CHUNK_COST["sq_tma" if route.tma else "sq"]), route


def _plan(kind: str, width: int, nq: int, n: int, kp: int, dev,
          floor: bool = False):
    """`_layout`'s plan as the C entries take it: (queries a block,
    chunk_rows, G)."""
    qb, plan = _layout(kind, width, nq, n, kp, dev, floor)
    return qb, plan.chunk_rows, plan.G


@functools.lru_cache(maxsize=64)
def _tensor_map(ptr: int, n: int, d: int):
    """The TMA route's tensor map over the codes at `ptr` (n, d): 128 bytes
    from repro_sq_tensor_map, kept per (pointer, n, d), so a batch encodes
    none."""
    buf = (ctypes.c_ubyte * 128)()
    fn = _build.function("repro_sq_tensor_map",
                         [_build.PTR] + [_build.INT] * 2 + [_build.PTR])
    _build.check(fn(ptr, n, d, ctypes.addressof(buf)),
                 "adc_topk.sq_adc_topk's tensor map")
    return buf


def _outputs(nq: int, kp: int, dtype, dev):
    """(dists (nq, kp) of dtype, ids (nq, kp) int64), uninitialized."""
    return (torch.empty((nq, kp), dtype=dtype, device=dev),
            torch.empty((nq, kp), dtype=torch.int64, device=dev))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(c8: torch.Tensor) -> bool:
    """The codes start on 16 bytes, as a tensor map's rows must."""
    return c8.data_ptr() % 16 == 0


def _launch_sq(q8, c8, cn, okb, out_d, out_i, floor_in, floor_out, kp: int,
               chunk_rows: int, G: int):
    """One pass of K4 on the card with the block plan given: the rows in G
    chunks of chunk_rows (whole tiles), one block per (query group,
    chunk), then the per-query merge, on the shape's route (`_sq_layout`);
    counted in `launches`."""
    nq, d = q8.shape
    n = c8.shape[0]
    dev = q8.device
    route = _sq_layout(d, nq, n, kp, dev, floor_in is not None,
                       _aligned(c8))[2]
    tmap = None
    if route.tma:
        tmap = ctypes.addressof(_tensor_map(c8.data_ptr(), n, d))
    part = torch.empty((nq, G, kp), dtype=torch.int64, device=dev)
    fn = _build.function("repro_sq_adc_topk", _SQ_ARGTYPES)
    err = fn(q8.data_ptr(), c8.data_ptr(), cn.data_ptr(), okb.data_ptr(),
             part.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
             _ptr(floor_in), _ptr(floor_out), nq, n, d, kp, chunk_rows, G,
             tmap, int(route.qreg), route.stages, dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "adc_topk.sq_adc_topk")
    launches["sq_adc_topk"] += 1


def _launch_pq(lut, codes_t, okb, out_d, out_i, floor_in, floor_out,
               kp: int, qb: int, chunk_rows: int, G: int):
    """One pass of K5 on the card, qb queries a block, with the block plan
    given (as `_launch_sq`)."""
    nq, m, _ = lut.shape
    dev = lut.device
    part = torch.empty((nq, G, kp), dtype=torch.int64, device=dev)
    fn = _build.function("repro_pq_adc_topk", _PQ_ARGTYPES)
    err = fn(lut.data_ptr(), codes_t.data_ptr(), okb.data_ptr(),
             part.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
             _ptr(floor_in), _ptr(floor_out), nq, codes_t.shape[1], m, kp,
             qb, chunk_rows, G, dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "adc_topk.pq_adc_topk")
    launches["pq_adc_topk"] += 1


def sq_adc_topk(q8: torch.Tensor, c8: torch.Tensor, cn: torch.Tensor,
                ok: torch.Tensor, kp: int):
    """Fused int8 ADC scan + top-kp.

    q8 (nq, d) int8, c8 (n, d) int8, cn (n,) any integer dtype (made
    int32), ok (n,) row validity (nonzero = valid) -> (dists (nq, kp)
    int32 ascending, ids (nq, kp) int64), ties to the lowest id; slots
    beyond the valid rows are (INT_BIG, -1).  kp = min(kp, n).  CUDA
    tensors must have those dtypes and be contiguous; the kernels run on
    the current stream without synchronizing (a kp above MAX_KP waits for
    each pass's ids)."""
    meta = on_meta(q8, c8, cn, ok)
    if not meta and on_cpu(q8, c8, cn, ok):
        return plain_sq_adc_topk(q8, c8, cn, ok, kp)
    if (q8.dim() != 2 or c8.dim() != 2 or q8.shape[1] != c8.shape[1]
            or cn.shape != (c8.shape[0],)):
        raise ValueError(f"sq_adc_topk needs q8 (nq, d), c8 (n, d), cn (n,); "
                         f"got {tuple(q8.shape)}, {tuple(c8.shape)}, "
                         f"{tuple(cn.shape)}")
    if q8.dtype != torch.int8 or c8.dtype != torch.int8:
        raise TypeError(f"the int8 ADC kernel takes int8 q8 and c8; got "
                        f"{q8.dtype}, {c8.dtype}")
    cn = int_operand(cn, "adc_topk.sq_adc_topk's cn")
    if not all(t.is_contiguous() for t in (q8, c8, cn)):
        raise ValueError("the int8 ADC kernel takes contiguous q8, c8, cn")
    nq, d = q8.shape
    n = c8.shape[0]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"d={d} outside the int8 ADC kernel's 1..{MAX_D}")
    okb = _row_validity(ok, n)
    kp = min(int(kp), n)
    dev = q8.device
    if meta or kp <= 0 or nq == 0:
        return _outputs(nq, max(kp, 0), torch.int32, dev)

    aligned = _aligned(c8)

    def one_pass(kp, floor_in, floor_out):
        plan = _sq_layout(d, nq, n, kp, dev, floor_in is not None, aligned)[1]
        out_d, out_i = _outputs(nq, kp, torch.int32, dev)
        _launch_sq(q8, c8, cn, okb, out_d, out_i, floor_in, floor_out, kp,
                   plan.chunk_rows, plan.G)
        count_plan("adc_topk.sq_adc_topk", plan)
        return out_d, out_i

    return floor_passes(kp, MAX_KP, nq, one_pass, INT_BIG, dev)


def pq_adc_topk(lut: torch.Tensor, codes_t: torch.Tensor, ok: torch.Tensor,
                kp: int):
    """Fused PQ ADC scan + top-kp.

    lut (nq, m, 256) per-query tables of any float dtype (made float32),
    codes_t (m, n) uint8, ok (n,) row validity -> (dists (nq, kp) float32
    ascending, each summed over j = 0..m-1 in that order; ids (nq, kp)
    int64), ties to the lowest id; slots beyond the valid rows are (+inf,
    -1).  kp = min(kp, n).  An m whose tables do not fit in shared memory
    is refused.  CUDA tensors must have those dtypes and be contiguous."""
    meta = on_meta(lut, codes_t, ok)
    if not meta and on_cpu(lut, codes_t, ok):
        return plain_pq_adc_topk(lut, codes_t, ok, kp)
    if (lut.dim() != 3 or lut.shape[2] != PQ_K or codes_t.dim() != 2
            or codes_t.shape[0] != lut.shape[1]):
        raise ValueError(f"pq_adc_topk needs lut (nq, m, {PQ_K}) and "
                         f"codes_t (m, n); got {tuple(lut.shape)}, "
                         f"{tuple(codes_t.shape)}")
    if codes_t.dtype != torch.uint8:
        raise TypeError(f"the PQ ADC kernel takes uint8 codes_t; got "
                        f"{codes_t.dtype}")
    lut = float_operand(lut, "adc_topk.pq_adc_topk's lut")
    if not (lut.is_contiguous() and codes_t.is_contiguous()):
        raise ValueError("the PQ ADC kernel takes contiguous lut, codes_t")
    nq, m, _ = lut.shape
    n = codes_t.shape[1]
    if m < 1:
        raise ValueError("pq_adc_topk needs m >= 1 subspaces")
    okb = _row_validity(ok, n)
    kp = min(int(kp), n)
    dev = lut.device
    if meta or kp <= 0 or nq == 0:
        return _outputs(nq, max(kp, 0), torch.float32, dev)

    def one_pass(kp, floor_in, floor_out):
        qb, plan = _layout("pq", m, nq, n, kp, dev, floor_in is not None)
        out_d, out_i = _outputs(nq, kp, torch.float32, dev)
        _launch_pq(lut, codes_t, okb, out_d, out_i, floor_in, floor_out, kp,
                   qb, plan.chunk_rows, plan.G)
        count_plan("adc_topk.pq_adc_topk", plan)
        return out_d, out_i

    return floor_passes(kp, MAX_KP, nq, one_pass, float("inf"), dev)


def _count_rows(where: str, rows: int) -> None:
    prof = active_profiler()
    if prof is not None:
        prof.count("adc_topk.sq_encode_queries", **{f"{where}_rows": rows})


def sq_encode_queries(Q: torch.Tensor, offset: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """K4's int8 query operand on the codebook's grid.

    Q (nq, d) of any float dtype (made float32), offset (d,) float32,
    scale a float (rounded to float32) -> q8 (nq, d) int8, rint((Q -
    offset) / scale) clipped to [-127, 127]: `SQCodebook.encode_query`'s
    codes, bit for bit.  CUDA tensors launch one kernel on the current
    stream without synchronizing (counted in `launches`), CPU tensors run
    the plain version; a profiler counts the rows as `card_rows` or
    `host_rows`."""
    meta = on_meta(Q, offset)
    if not meta and on_cpu(Q, offset):
        _count_rows("host", Q.shape[0])
        return plain_sq_encode_queries(Q, offset, scale)
    if Q.dim() != 2 or offset.shape != (Q.shape[1],):
        raise ValueError(f"sq_encode_queries needs Q (nq, d) and offset "
                         f"(d,); got {tuple(Q.shape)}, {tuple(offset.shape)}")
    if offset.dtype != torch.float32:
        raise TypeError(f"sq_encode_queries takes a float32 offset; got "
                        f"{offset.dtype}")
    Q = float_operand(Q, "adc_topk.sq_encode_queries' Q").contiguous()
    offset = offset.contiguous()
    nq, d = Q.shape
    dev = Q.device
    q8 = torch.empty((nq, d), dtype=torch.int8, device=dev)
    if meta or q8.numel() == 0:
        return q8
    fn = _build.function("repro_sq_encode_queries", _ENC_ARGTYPES)
    _build.check(fn(Q.data_ptr(), offset.data_ptr(), float(scale),
                    q8.data_ptr(), nq, d, dev.index,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "adc_topk.sq_encode_queries")
    launches["sq_encode_queries"] += 1
    _count_rows("card", nq)
    return q8
