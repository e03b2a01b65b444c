"""The reference's flat filter: the k' rows whose SAP ciphertexts lie
nearest each query ciphertext, by an exhaustive scan (in float64, or in
TF32 for the control)."""

from __future__ import annotations

import torch

from bench_h100.reference import sq_dists


class Filter:
    def __init__(self, C: torch.Tensor, mode: str):
        self.C = C.double() if mode == "reference" else C.float()
        self.mode = mode

    def candidates(self, Qs: torch.Tensor, kp: int) -> torch.Tensor:
        """(b, kp) int64 row ids, nearest first."""
        d = sq_dists(Qs, self.C, self.mode)
        return torch.topk(d, kp, dim=1, largest=False, sorted=True).indices
