"""Secure k-NN primitives over DCE ciphertexts (paper §IV-B end, §V-B).

Two refine/scan strategies:
  * `DCEMaxHeap` + `linear_scan_heap` / `refine_heap` — the paper's exact
    algorithms (max-heap keyed by DCE comparisons; O(log k) comparisons per
    candidate).  Comparison counts are instrumented for the cost tables.
  * `linear_scan_tournament` / `refine_tournament` — the accelerator
    adaptation: chunked pairwise Z-matrix win-count selection through the
    CUDA tile kernel (repro_torch.kernels.dce_comp).  Exact, because DCE
    comparisons are exact.  `device=None` means the card; pass
    `device="cpu"` for the plain versions on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.dce_comp import ops as dce_ops
from . import dce

__all__ = [
    "DCEMaxHeap",
    "linear_scan_heap",
    "linear_scan_tournament",
    "refine_heap",
    "refine_tournament",
]


class DCEMaxHeap:
    """Binary max-heap whose comparator is the encrypted DistanceComp.

    The server never sees distance values — only signs of
    Z = DistanceComp(C_i, C_j, T_q) (Theorem 3).  `worst` is the root.
    """

    def __init__(self, C_db: np.ndarray, T_q: np.ndarray, k: int):
        self.C = C_db
        self.T = T_q
        self.k = k
        self.ids: list[int] = []
        self.n_comparisons = 0

    def _further(self, i: int, j: int) -> bool:
        """True iff dist(ids[i], q) > dist(ids[j], q)."""
        self.n_comparisons += 1
        z = dce.distance_comp(self.C[self.ids[i]], self.C[self.ids[j]], self.T)
        return bool(z > 0)

    def _sift_up(self, pos: int):
        while pos > 0:
            parent = (pos - 1) // 2
            if self._further(pos, parent):
                self.ids[pos], self.ids[parent] = self.ids[parent], self.ids[pos]
                pos = parent
            else:
                return

    def _sift_down(self, pos: int):
        n = len(self.ids)
        while True:
            l, r = 2 * pos + 1, 2 * pos + 2
            big = pos
            if l < n and self._further(l, big):
                big = l
            if r < n and self._further(r, big):
                big = r
            if big == pos:
                return
            self.ids[pos], self.ids[big] = self.ids[big], self.ids[pos]
            pos = big

    def offer(self, cand: int):
        """Algorithm 2 lines 3-9: insert if heap not full, else replace the
        current worst when the candidate compares closer."""
        if len(self.ids) < self.k:
            self.ids.append(cand)
            self._sift_up(len(self.ids) - 1)
            return
        # DistanceComp(C_top, C_cand, T) > 0 <=> top is further than cand
        self.n_comparisons += 1
        z = dce.distance_comp(self.C[self.ids[0]], self.C[cand], self.T)
        if z > 0:
            self.ids[0] = cand
            self._sift_down(0)

    def result(self) -> np.ndarray:
        return np.asarray(self.ids, np.int64)


def linear_scan_heap(C_db: np.ndarray, T_q: np.ndarray, k: int):
    """Paper §IV-B: exact secure k-NN by linear scan + DCE max-heap.

    Returns (ids (k,), n_comparisons).  O(n d log k) — the cost the index
    exists to avoid.
    """
    heap = DCEMaxHeap(C_db, T_q, k)
    for i in range(C_db.shape[0]):
        heap.offer(i)
    return heap.result(), heap.n_comparisons


def refine_heap(C_cands: np.ndarray, cand_ids: np.ndarray, T_q: np.ndarray,
                k: int):
    """Algorithm 2 refine phase over a candidate subset."""
    heap = DCEMaxHeap(C_cands, T_q, k)
    for i in range(C_cands.shape[0]):
        heap.offer(i)
    local = heap.result()
    return np.asarray(cand_ids)[local], heap.n_comparisons


def _tournament_topk(C: np.ndarray, T: np.ndarray, k: int,
                     device=None) -> np.ndarray:
    device = resolve_device(device)
    idx = dce_ops.top_k_by_wins(
        torch.as_tensor(C, dtype=torch.float32, device=device).contiguous(),
        torch.as_tensor(T, dtype=torch.float32, device=device).contiguous(),
        min(k, C.shape[0]))
    return idx.cpu().numpy().astype(np.int64)


def refine_tournament(C_cands: np.ndarray, cand_ids: np.ndarray,
                      T_q: np.ndarray, k: int, device=None):
    """Accelerator refine: one pairwise Z-matrix + win-count ranking
    (exact)."""
    local = _tournament_topk(C_cands, T_q, k, device)
    n = C_cands.shape[0]
    return np.asarray(cand_ids)[local], n * (n - 1)


def linear_scan_tournament(C_db: np.ndarray, T_q: np.ndarray, k: int,
                           chunk: int = 512, device=None):
    """Chunked exact scan: per chunk keep top-k by win counts, then merge
    with the running top-k (top-k of a union == top-k of per-part top-ks)."""
    n = C_db.shape[0]
    best = np.zeros(0, np.int64)
    comparisons = 0
    for start in range(0, n, chunk):
        ids = np.arange(start, min(start + chunk, n))
        pool = np.concatenate([best, ids])
        Cp = C_db[pool]
        local = _tournament_topk(Cp, T_q, k, device)
        comparisons += len(pool) * (len(pool) - 1)
        best = pool[local]
    return best, comparisons
