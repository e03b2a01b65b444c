"""Plain PyTorch versions of the adc_topk kernels: quantized-ADC scan
plus top-kp, as `repro.kernels.adc_topk` defines them.

Distances are the ranking surrogates, not squared L2 itself:

  int8 (SQ):  d_i = cn_i - 2 * (q8 . c8_i), int32-exact: the cross term is
              a true-fp32 product of int8 values (exact for d <= 1040),
              turned into int32 before the subtraction, and the running
              top-kp state is int32, so no surrogate is rounded;
  pq8  (PQ):  d_i = sum_j lut[:, j, codes_t[j, i]], float32, one add at a
              time in ascending j — the order of the numpy oracle
              `repro.kernels.adc_topk.ref.pq_dists`, so the distances are
              bit-equal to it.

Both return (dists (nq, kp), ids (nq, kp) int64), ascending, ties to the
lowest id (a stable merge, as `lax.top_k` of the negated row).  Rows with
ok = 0 never win a slot: a slot whose distance is >= the sentinel
(INT_BIG, +inf) comes back as (sentinel, -1), so fewer valid rows than
kp give empty slots, never a duplicated id.  kp = min(kp, n).

The int8 query operand (`sq_encode_queries`) is the codebook's grid,
rint((Q - offset) / scale) clipped to [-127, 127] in float32: the
`core.adc.SQCodebook.encode_query` codes, bit for bit.
"""

from __future__ import annotations

import torch

from ...device import full_fp32
from ..common import running_topk_scan

__all__ = ["INT_BIG", "CHUNK", "sq_dists", "pq_dists", "sq_adc_topk",
           "pq_adc_topk", "sq_encode_queries"]

INT_BIG = 2 ** 30          # sentinel surrogate distance of the int8 path
CHUNK = 8192               # rows per merge step


def sq_dists(q8: torch.Tensor, c8: torch.Tensor,
             cn: torch.Tensor) -> torch.Tensor:
    """(nq, d) int8, (n, d) int8, (n,) int32 -> (nq, n) int32."""
    full_fp32()
    cross = q8.to(torch.float32) @ c8.to(torch.float32).T
    return cn.to(torch.int32)[None, :] - 2 * cross.to(torch.int32)


def pq_dists(lut: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
    """(nq, m, 256) float, (m, n) uint8 -> (nq, n) float32."""
    lut = lut.to(torch.float32)
    out = torch.zeros((lut.shape[0], codes_t.shape[1]), dtype=torch.float32,
                      device=lut.device)
    for j in range(codes_t.shape[0]):
        out = out + lut[:, j, codes_t[j].long()]
    return out


def _topk(dist_fn, nq: int, n: int, kp: int, dtype, big, device):
    kp = min(kp, n)
    if kp <= 0:
        return (torch.empty((nq, 0), dtype=dtype, device=device),
                torch.empty((nq, 0), dtype=torch.int64, device=device))
    chunk = min(CHUNK, n)

    def block(start):
        d = dist_fn(start, min(start + chunk, n))
        short = chunk - d.shape[1]
        if short:
            d = torch.nn.functional.pad(d, (0, short), value=big)
        return d

    d, ids = running_topk_scan(block, n, nq, kp, chunk, device, dtype=dtype,
                               fill=big)
    gone = d >= big
    return torch.where(gone, big, d), torch.where(gone, -1, ids)


def sq_adc_topk(q8, c8, cn, ok, kp: int):
    """Fused int8 ADC scan + top-kp (int32 state filled with INT_BIG)."""
    valid = ok != 0

    def dist_fn(start, stop):
        d = sq_dists(q8, c8[start:stop], cn[start:stop])
        return torch.where(valid[start:stop][None, :], d, INT_BIG)

    return _topk(dist_fn, q8.shape[0], c8.shape[0], kp, torch.int32,
                 INT_BIG, q8.device)


def pq_adc_topk(lut, codes_t, ok, kp: int):
    """Fused PQ ADC scan + top-kp (float32 state filled with +inf)."""
    valid = ok != 0
    lut = lut.to(torch.float32)

    def dist_fn(start, stop):
        d = pq_dists(lut, codes_t[:, start:stop])
        return torch.where(valid[start:stop][None, :], d, float("inf"))

    return _topk(dist_fn, lut.shape[0], codes_t.shape[1], kp, torch.float32,
                 float("inf"), lut.device)


def sq_encode_queries(Q: torch.Tensor, offset: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """(nq, d) float (made float32), (d,) float32, scale -> (nq, d) int8:
    a true float32 division by the scale rounded to float32 (a tensor
    divisor: no multiplication by a rounded reciprocal), then round half
    to even."""
    s = torch.full((), scale, dtype=torch.float32, device=Q.device)
    q = torch.round((Q.to(torch.float32) - offset) / s)
    return q.clamp_(-127, 127).to(torch.int8)
