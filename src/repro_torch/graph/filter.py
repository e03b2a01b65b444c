"""GraphFilter — the batched device-resident HNSW filter backend
(DESIGN.md §15), counterpart of `repro.graph.filter`.

The same owner-built HNSW over DCPE ciphertexts as `HNSWGraphFilter`,
but the walk runs batched over the CSR mirror for the whole query set:
one launch of the graph_expand CUDA kernel for the upper-layer descent
and the layer-0 beam search (`kernels/graph_expand/ops.graph_topk`).
`oblivious=True` runs the bounded-hop, fixed-fanout torch walk
(constant hop/edge counts) of the `hardened` tier.  `quantization="int8"|"pq8"` scores edges with the ADC surrogates
of `core.adc` (codebook trained keylessly at attach, as `ADCFilter`
does) and oversamples candidates for the exact refine; as in the
reference, those walks and the oblivious one run the torch walk, and
the graph_expand kernel takes the f32 perf walk.

The host walk stays as the parity oracle: ids are recall-identical at
fixed ef, per the equivalence argument in `graph.traverse`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import adc_codes
from ..core.hnsw import HNSW
from ..device import resolve_device
from ..obs.trace import child_span
from .csr import CSRGraph
from .traverse import beam_plan

__all__ = ["GraphFilter"]


class GraphFilter:
    """Batched CSR traversal filter backend for `SecureSearchEngine`.

    index: the owner-built `core.hnsw.HNSW` (over DCPE ciphertexts).
    quantization: None (exact f32 ciphertext distances) | "int8" |
    "pq8" (ADC surrogate edge scoring + candidate oversampling).
    oblivious: bounded-hop fixed-fanout traversal (the `hardened`
    profile's tier); returned ids are bit-identical to the perf variant.
    The arrays live on the engine's device (`attach`).  The reference's
    `use_kernel=` option is not ported.
    """

    def __init__(self, index: HNSW, *, quantization: str | None = None,
                 refine_ratio: float | None = None, pq_m: int = 16,
                 oblivious: bool = False, seed: int = 0):
        if quantization not in (None, "int8", "pq8"):
            raise ValueError(f"GraphFilter quantization must be "
                             f"None|int8|pq8, got {quantization!r}")
        self.index = index
        self.quantization = quantization
        self.quant = quantization or "f32"
        self.name = ("graph" if quantization is None
                     else f"adc-graph-{quantization}")
        self.refine_ratio = adc_codes.refine_ratio(quantization,
                                                   refine_ratio)
        self.pq_m = pq_m
        self.oblivious = oblivious
        self.seed = seed
        self.codes = adc_codes.make(quantization)
        self.csr: CSRGraph | None = None
        self._neigh0 = self._neigh_up = self._ok = None
        self._db = None
        self._row_bytes = 0
        self.last_filter_bytes = 0
        self.last_n_hops = 0
        self.last_n_edges_scanned = 0
        self.last_scan_trace: np.ndarray | None = None

    # --------------------------------------------------------------- setup

    @property
    def codebook(self):
        return None if self.codes is None else self.codes.codebook

    def oversampled(self, kp: int) -> int:
        return adc_codes.oversampled(kp, self.refine_ratio)

    def attach(self, C_sap: np.ndarray, engine=None):
        """Mirror the host graph into CSR rows and upload them, with the
        row validity and the scan arrays (ciphertext rows, or their ADC
        codes padded to the row capacity R), to the engine's device (the
        card without an engine)."""
        device = engine.device if engine is not None else resolve_device()
        self.csr = CSRGraph.from_hnsw(self.index)
        g = self.csr
        # free the old device copies before the new ones are uploaded
        self._neigh0 = self._neigh_up = self._ok = self._db = None
        self._neigh0 = torch.from_numpy(g.neigh0).to(device)
        self._neigh_up = torch.from_numpy(g.neigh_up).to(device)
        self._ok = torch.from_numpy(g.levels >= 0).to(device)
        if self.codes is None:
            # g.X carries +inf for deleted rows; `ok` masks them, and
            # scores are computed in diff form so the zeros put there
            # are inert
            X = np.where(np.isfinite(g.X), g.X, 0.0).astype(np.float32)
            self._db = (torch.from_numpy(X).to(device),)
            self._row_bytes = g.d * 4
            return
        rows = np.where(np.isfinite(g.X[: g.n]), g.X[: g.n], 0.0)
        rows = rows.astype(np.float32)
        self.codes.train(rows, m=self.pq_m, seed=self.seed)
        self.codes.encode(rows, g.R,
                          lambda buf, axis: torch.from_numpy(buf).to(device))
        self._db = self.codes.arrays
        self._row_bytes = self.codes.row_bytes

    # ---------------------------------------------------------- candidates

    def candidates(self, Q_sap: np.ndarray, kp: int, ef_search: int):
        from ..kernels.graph_expand import ops as graph_ops
        Q = np.asarray(Q_sap, np.float32)
        nq = Q.shape[0]
        g = self.csr
        kp2 = max(1, min(self.oversampled(kp), max(g.n, 1)))
        ef_eff, ef_cap, max_hops = beam_plan(kp2, max(ef_search, kp2))
        if self.codes is None:
            with child_span("filter.query_prep"):
                qd = torch.from_numpy(Q).to(self._ok.device)
        else:
            qd = self.codes.query_operand(Q, self._ok.device)
        cand, _, visited, hops, edges = graph_ops.graph_topk(
            self._neigh0, self._neigh_up, self._ok, self._db, qd,
            g.entry, ef_eff, kp=kp2, ef_cap=ef_cap, max_hops=max_hops,
            quant=self.quant, oblivious=self.oblivious)
        valid = cand >= 0
        cand = torch.where(valid, cand, 0)
        n_edges = int(edges.sum())
        self.last_n_hops = int(hops.sum())
        self.last_n_edges_scanned = n_edges
        # every scored edge reads one row (f32) or one code row (ADC),
        # plus the entry-point read per query
        self.last_filter_bytes = (n_edges + nq) * self._row_bytes
        self.last_scan_trace = visited.cpu().numpy()
        return cand, valid, n_edges + nq
