"""GraphFilter — the batched device-resident HNSW filter backend
(DESIGN.md §15), counterpart of `repro.graph.filter`.

The same owner-built HNSW over DCPE ciphertexts as `HNSWGraphFilter`,
but the walk runs batched over the CSR mirror for the whole query set:
the upper-layer descent in torch ops, then one launch of the
graph_expand CUDA kernel for the layer-0 beam search (`kernels/
graph_expand/ops.graph_topk`).  `oblivious=True` runs the bounded-hop,
fixed-fanout torch walk (constant hop/edge counts) of the `hardened`
tier.  Only exact f32 edge scoring is ported; the ADC-quantized
variants come with the ADC slice.

The host walk stays as the parity oracle: ids are recall-identical at
fixed ef, per the equivalence argument in `graph.traverse`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.hnsw import HNSW
from ..device import resolve_device
from .csr import CSRGraph
from .traverse import beam_plan

__all__ = ["GraphFilter"]


class GraphFilter:
    """Batched CSR traversal filter backend for `SecureSearchEngine`.

    index: the owner-built `core.hnsw.HNSW` (over DCPE ciphertexts).
    quantization: None only (exact f32 ciphertext distances; the ADC
    options `pq_m` and `seed` come with the ADC slice).
    oblivious: bounded-hop fixed-fanout traversal (the `hardened`
    profile's tier); returned ids are bit-identical to the perf variant.
    The arrays live on the engine's device (`attach`).
    """

    def __init__(self, index: HNSW, *, quantization: str | None = None,
                 refine_ratio: float | None = None, oblivious: bool = False):
        if quantization is not None:
            raise NotImplementedError(
                "ADC-quantized graph filters come with the ADC slice of the "
                "port (ROADMAP Queue 1 item 6)")
        self.index = index
        self.name = "graph"
        self.refine_ratio = (1.0 if refine_ratio is None
                             else float(refine_ratio))
        self.oblivious = oblivious
        self.csr: CSRGraph | None = None
        self._neigh0 = self._neigh_up = self._ok = None
        self._db = None
        self._row_bytes = 0
        self.last_filter_bytes = 0
        self.last_n_hops = 0
        self.last_n_edges_scanned = 0
        self.last_scan_trace: np.ndarray | None = None

    # --------------------------------------------------------------- setup

    def oversampled(self, kp: int) -> int:
        return max(kp, int(np.ceil(kp * self.refine_ratio)))

    def attach(self, C_sap: np.ndarray, engine=None):
        """Mirror the host graph into CSR rows and upload them, with the
        row validity and the ciphertext rows, to the engine's device
        (the card without an engine)."""
        device = engine.device if engine is not None else resolve_device()
        self.csr = CSRGraph.from_hnsw(self.index)
        g = self.csr
        # free the old device copies before the new ones are uploaded
        self._neigh0 = self._neigh_up = self._ok = self._db = None
        self._neigh0 = torch.from_numpy(g.neigh0).to(device)
        self._neigh_up = torch.from_numpy(g.neigh_up).to(device)
        self._ok = torch.from_numpy(g.levels >= 0).to(device)
        # g.X carries +inf for deleted rows; `ok` masks them, and scores
        # are computed in diff form so the zeros put there are inert
        X = np.where(np.isfinite(g.X), g.X, 0.0).astype(np.float32)
        self._db = (torch.from_numpy(X).to(device),)
        self._row_bytes = g.d * 4

    # ---------------------------------------------------------- candidates

    def candidates(self, Q_sap: np.ndarray, kp: int, ef_search: int):
        from ..kernels.graph_expand import ops as graph_ops
        Q = np.asarray(Q_sap, np.float32)
        nq = Q.shape[0]
        g = self.csr
        kp2 = max(1, min(self.oversampled(kp), max(g.n, 1)))
        ef_eff, ef_cap, max_hops = beam_plan(kp2, max(ef_search, kp2))
        cand, _, visited, hops, edges = graph_ops.graph_topk(
            self._neigh0, self._neigh_up, self._ok, self._db,
            torch.from_numpy(Q).to(self._db[0].device), g.entry, ef_eff,
            kp=kp2, ef_cap=ef_cap, max_hops=max_hops, quant="f32",
            oblivious=self.oblivious)
        valid = cand >= 0
        cand = torch.where(valid, cand, 0)
        n_edges = int(edges.sum())
        self.last_n_hops = int(hops.sum())
        self.last_n_edges_scanned = n_edges
        # every scored edge reads one row, plus the entry-point read per
        # query
        self.last_filter_bytes = (n_edges + nq) * self._row_bytes
        self.last_scan_trace = visited.cpu().numpy()
        return cand, valid, n_edges + nq
