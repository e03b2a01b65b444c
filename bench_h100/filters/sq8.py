"""The reference's int8 filter: the quantizer of the configuration worked
out again from the SAP ciphertexts, then an exact integer scan.

The quantizer is SQ8 with per-dimension offsets and one global scale
(the configuration's file names its source): offset = (min + max) / 2
per dimension, scale = max |c - offset| / 127, codes = round-to-even of
(c - offset) / scale in float32, clipped to [-127, 127]; queries take the
same grid.  The surrogate cn - 2 q8.c8 (cn = ||c8||^2) ranks as the
squared distance of the codes; the k' smallest are kept, ties to the
lowest id.  The control quantizes to int4 ([-7, 7], scale / 7) and
ranks the same way, with the refine in TF32 (`reference.sq_dists`).
"""

from __future__ import annotations

import torch


class Filter:
    def __init__(self, C: torch.Tensor, mode: str):
        self.qmax = 127 if mode == "reference" else 7
        C = C.float()
        self.offset = (C.min(0).values + C.max(0).values) / 2
        spread = float((C - self.offset).abs().max())
        # a device tensor, so the division is a true float32 division
        # as numpy's, not a multiplication by a rounded reciprocal
        self.scale = torch.tensor(max(spread, 1e-12) / self.qmax,
                                  dtype=torch.float32, device=C.device)
        self.codes = self._encode(C)
        self.cn = (self.codes * self.codes).sum(1)
        self.shift = float(2 ** C.shape[0].bit_length())
        self.ids = torch.arange(C.shape[0], dtype=torch.float64,
                                device=C.device)

    def _encode(self, X: torch.Tensor) -> torch.Tensor:
        q = torch.round((X.float() - self.offset) / self.scale)
        return q.clamp_(-self.qmax, self.qmax).double()

    def candidates(self, Qs: torch.Tensor, kp: int) -> torch.Tensor:
        """(b, kp) int64 row ids, smallest surrogate first, ties to the
        lowest id: each key surrogate * 2^bits(n) + id is exact in
        float64 and unique."""
        key = (self._encode(Qs) @ self.codes.T).mul_(-2.0)
        key.add_(self.cn).mul_(self.shift).add_(self.ids)
        return torch.topk(key, kp, dim=1, largest=False, sorted=True).indices
