"""Public wrappers around the adc_topk kernels, and the IVF pool scans.

Counterpart of `repro.kernels.adc_topk.ops`:

  sq_knn / pq_knn   — the quantized analogues of `l2_topk.ops.knn`: one
      call scans the whole code array and returns the top-k by ADC
      surrogate distance, through the fused kernel (`adc_topk`: CUDA
      tensors launch it once, CPU tensors run its plain version).  An
      optional `ok` row validity masks padded or deleted rows.
  sq_pool_scan / pq_pool_scan — the IVF-pruned scans: per-query gathers
      over the probed rows (a gather workload; the reference keeps them
      in XLA, here they are torch ops);
  sq_oblivious_scan / pq_oblivious_scan — the scan-oblivious IVF scans:
      every row's surrogate, masked by per-query pool membership;
  *_pool_dists / *_oblivious_dists — those four scans' masked distances
      before their top-kp (the sharded backend merges them across
      shards);
  sq_encode_queries — the int8 query operand, quantized where the
      queries lie (`adc_topk.sq_encode_queries`: the card's kernel or
      its plain version); the reference makes it in numpy on the host.

The four pool and oblivious scans keep the reference's float32
`cn - 2 * cross`, exact while the surrogate stays below 2^24 (d <= 346;
the cross term alone is exact for d <= 1040), and the PQ sums in
ascending subspace order.  `lax.top_k` of the negated distances becomes
a stable ascending sort (ties to the lowest position).  The reference's
`use_kernel=` switch is not ported: CUDA tensors always take the kernel.  The six scans are wrapped by the
opt-in kernel profiler (`obs.profiler`), and the query encode under its
own name, so the scans' entries time the scans alone.
"""

from __future__ import annotations

import torch

from ...device import full_fp32
from ...obs.profiler import instrument as _instrument
from ..common import top_positions
from .adc_topk import INT_BIG, pq_adc_topk, sq_adc_topk, sq_encode_queries
from .ref import pq_dists

__all__ = ["sq_knn", "pq_knn", "sq_pool_scan", "pq_pool_scan",
           "sq_oblivious_scan", "pq_oblivious_scan", "sq_pool_dists",
           "pq_pool_dists", "sq_oblivious_dists", "pq_oblivious_dists",
           "sq_adc_topk", "pq_adc_topk", "sq_encode_queries", "INT_BIG"]

_GATHER_ELEMENTS = 2 ** 27      # gathered code elements per step (int8 pool)


def sq_knn(q8: torch.Tensor, c8: torch.Tensor, cn: torch.Tensor, k: int, *,
           ok: torch.Tensor | None = None):
    """Top-k by int8 ADC surrogate cn - 2 (q8 . c8).

    q8 (nq, d) int8, c8 (n, d) int8, cn (n,) int32, ok optional (n,)
    validity -> (dists (nq, k) int32 ascending, ids (nq, k) int64);
    slots beyond the valid rows are (INT_BIG, -1)."""
    if ok is None:
        ok = torch.ones(c8.shape[0], dtype=torch.bool, device=c8.device)
    return sq_adc_topk(q8, c8, cn, ok, k)


def pq_knn(lut: torch.Tensor, codes_t: torch.Tensor, k: int, *,
           ok: torch.Tensor | None = None):
    """Top-k by PQ ADC distance sum_j lut[:, j, codes_t[j]].

    lut (nq, m, 256) float32, codes_t (m, n) uint8, ok optional (n,)
    validity -> (dists (nq, k) float32 ascending, ids (nq, k) int64);
    slots beyond the valid rows are (+inf, -1)."""
    if ok is None:
        ok = torch.ones(codes_t.shape[1], dtype=torch.bool,
                        device=codes_t.device)
    return pq_adc_topk(lut, codes_t, ok, k)


def sq_pool_dists(c8_dev, cn_dev, q8, cand, valid) -> torch.Tensor:
    """The int8 ADC surrogates of each query's probed rows: c8_dev (n, d)
    int8, cn_dev (n,) int32, q8 (nq, d) int8, cand/valid (nq, L) pool
    layout (`serving.search_engine.layout_pools`) -> (nq, L) float32,
    +inf at invalid slots.  The gathered rows are taken a few queries at
    a time, so no (nq, L, d) float block exists."""
    full_fp32()
    nq, L = cand.shape
    idx = cand.long()
    qf = q8.to(torch.float32)
    cross = torch.empty((nq, L), dtype=torch.float32, device=cand.device)
    step = max(1, _GATHER_ELEMENTS // max(1, L * c8_dev.shape[1]))
    for s in range(0, nq, step):
        rows = c8_dev[idx[s:s + step]].to(torch.float32)     # (b, L, d)
        cross[s:s + step] = torch.einsum("qld,qd->ql", rows, qf[s:s + step])
    d = cn_dev[idx].to(torch.float32) - 2.0 * cross
    return torch.where(valid, d, float("inf"))


def sq_pool_scan(c8_dev, cn_dev, q8, cand, valid, kp: int):
    """IVF-pruned int8 ADC scan over each query's probed rows: the top-kp
    of `sq_pool_dists` -> (ids (nq, kp) of cand's dtype, valid (nq, kp))."""
    pos = top_positions(sq_pool_dists(c8_dev, cn_dev, q8, cand, valid), kp)
    return torch.gather(cand, 1, pos), torch.gather(valid, 1, pos)


def pq_pool_dists(codes_t, lut, cand, valid) -> torch.Tensor:
    """The PQ ADC distances of each query's probed rows (table look-ups):
    codes_t (m, n) uint8, lut (nq, m, 256) float32, cand/valid (nq, L)
    -> (nq, L) float32, +inf at invalid slots."""
    idx = cand.long()
    d = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
    for j in range(codes_t.shape[0]):
        d = d + torch.gather(lut[:, j], 1, codes_t[j][idx].long())
    return torch.where(valid, d, float("inf"))


def pq_pool_scan(codes_t, lut, cand, valid, kp: int):
    """IVF-pruned PQ ADC scan: the top-kp of `pq_pool_dists` -> (ids
    (nq, kp), valid (nq, kp))."""
    pos = top_positions(pq_pool_dists(codes_t, lut, cand, valid), kp)
    return torch.gather(cand, 1, pos), torch.gather(valid, 1, pos)


def sq_oblivious_dists(c8_dev, cn_dev, q8, member) -> torch.Tensor:
    """The int8 ADC surrogate of EVERY row, masked (+inf) by member
    (nq, n) bool (`serving.search_engine.pool_membership`).  Member rows
    get the values `sq_pool_dists` computes for them."""
    full_fp32()
    cross = q8.to(torch.float32) @ c8_dev.to(torch.float32).T
    d = cn_dev.to(torch.float32)[None, :] - 2.0 * cross
    return torch.where(member, d, float("inf"))


def sq_oblivious_scan(c8_dev, cn_dev, q8, member, kp: int):
    """Scan-oblivious int8 ADC IVF scan: the top-kp of
    `sq_oblivious_dists` -> (ids (nq, kp) int64, valid (nq, kp)), the
    candidates `sq_pool_scan` finds."""
    pos = top_positions(sq_oblivious_dists(c8_dev, cn_dev, q8, member), kp)
    return pos, torch.gather(member, 1, pos)


def pq_oblivious_dists(codes_t, lut, member) -> torch.Tensor:
    """Every row's PQ table sum, masked (+inf) by member (nq, n) bool."""
    return torch.where(member, pq_dists(lut, codes_t), float("inf"))


def pq_oblivious_scan(codes_t, lut, member, kp: int):
    """Scan-oblivious PQ ADC IVF scan: the top-kp of `pq_oblivious_dists`
    -> (ids (nq, kp) int64, valid (nq, kp))."""
    pos = top_positions(pq_oblivious_dists(codes_t, lut, member), kp)
    return pos, torch.gather(member, 1, pos)


sq_knn = _instrument("adc_topk.sq_knn", sq_knn)
pq_knn = _instrument("adc_topk.pq_knn", pq_knn)
sq_pool_scan = _instrument("adc_topk.sq_pool_scan", sq_pool_scan)
pq_pool_scan = _instrument("adc_topk.pq_pool_scan", pq_pool_scan)
sq_oblivious_scan = _instrument("adc_topk.sq_oblivious_scan",
                                sq_oblivious_scan)
pq_oblivious_scan = _instrument("adc_topk.pq_oblivious_scan",
                                pq_oblivious_scan)
sq_encode_queries = _instrument("adc_topk.sq_encode_queries",
                                sq_encode_queries)
