"""Batched secure filter-and-refine engine on the card.

Counterpart of `repro.serving.search_engine`, as far as the flat and
graph paths:

  filter:  a pluggable backend produces k' candidate ids per query —
             * FlatScanFilter  — exhaustive scan of the DCPE ciphertexts
               through the l2_topk CUDA kernel (chunked distance tiles
               and a running top-k', no (nq, n) matrix in device memory);
             * `repro_torch.graph.GraphFilter` — the batched HNSW walk,
               its layer-0 beam search in the graph_expand CUDA kernel;
             * HNSWGraphFilter — the per-query host walk, kept as the
               graph filter's parity oracle.
  refine:  one batched DCE tournament over the candidate sets through the
           dce_comp CUDA kernel (`batched_top_k_by_wins`) — no per-query
           Python loop.

`SecureSearchEngine.search` is a batch-of-one wrapper over
`search_batch`, so the per-query and batched paths return identical ids.
The IVF backend and the quantized ADC filter come with later slices of
the port; asking for them raises `NotImplementedError`.

Privacy envelope: the engine sees only DCPE filter ciphertexts and DCE
refine ciphertexts / trapdoors — never plaintexts or true distances,
only ciphertext distances and comparison signs (the leakage proven in
the paper, §VI).
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from ..core import secure_knn
from ..core.hnsw import HNSW
from ..device import resolve_device
from ..kernels.dce_comp import ops as dce_ops
from ..kernels.l2_topk import ops as l2_ops
from ..obs.trace import child_span

__all__ = ["SearchStats", "SecureSearchEngine", "FlatScanFilter",
           "HNSWGraphFilter", "refine_candidates",
           "traverse_graph_candidates"]


@dataclasses.dataclass
class SearchStats:
    """Uniform per-call search accounting (single query or batch).

    Communication model (paper §V-C): user -> server is the DCPE query
    ciphertext + DCE trapdoor + k (4 bytes); server -> user is the
    serialized id matrix — int64 ids, so 8 bytes per returned slot.
    The fields and their meaning are those of the JAX package's
    `SearchStats`; the fields of backends not ported yet stay 0.
    """
    latency_s: float
    filter_dist_evals: int      # ciphertext distance evaluations (filter)
    refine_comparisons: int     # DCE DistanceComp sign evaluations (refine)
    bytes_up: int
    bytes_down: int
    n_queries: int = 1
    backend: str = ""
    # true bytes the filter touched this call (full-precision rows for
    # the f32 flat scan); 0 for an empty collection
    filter_bytes_scanned: int = 0
    # dummy padding rows injected by a scheduler under padding security
    # profiles
    n_dummy_queries: int = 0
    # graph-backend traversal accounting: 0 for scan backends
    n_hops: int = 0
    n_edges_scanned: int = 0
    # failover accounting: shard groups with no live replica, and
    # whether the answer is therefore partial
    n_shards_down: int = 0
    degraded: bool = False


# ---------------------------------------------------------------------------
# Batched refine — the one refine path every entry point routes through.
# ---------------------------------------------------------------------------

def refine_candidates(C_dce: torch.Tensor, cand: torch.Tensor,
                      T: torch.Tensor, valid: torch.Tensor | None,
                      k: int) -> torch.Tensor:
    """Exact DCE tournament refine of per-query candidate sets, batched.

    C_dce: (n, 4, D) refine ciphertexts; cand: (nq, kp) int64 candidate
    ids; T: (nq, D) trapdoors; valid: (nq, kp) bool or None (padded-slot
    mask) -> (nq, k) int64 ids, ascending true distance; -1 marks slots
    where a query had fewer than k real candidates (never a fabricated
    id).  All tensors on one device.
    """
    Cc = C_dce[cand]                                   # (nq, kp, 4, D)
    local = dce_ops.batched_top_k_by_wins(Cc, T, k, valid=valid)
    ids = torch.gather(cand, 1, local)
    if valid is None:
        return ids
    vsel = torch.gather(valid, 1, local)
    return torch.where(vsel, ids, -1)


# ---------------------------------------------------------------------------
# Filter backends.  Each returns (cand (nq, kp') int64, valid (nq, kp')
# bool, n_dist_evals) given a batch of DCPE-encrypted queries; cand and
# valid are tensors on the engine's device.
# ---------------------------------------------------------------------------

class FlatScanFilter:
    """Exhaustive l2_topk scan over all DCPE ciphertexts."""

    name = "flat"

    def __init__(self, chunk: int = 4096):
        self.chunk = chunk
        self._C = None
        self.last_filter_bytes = 0

    def attach(self, C_sap: np.ndarray, engine: "SecureSearchEngine"):
        self._C = torch.as_tensor(
            np.asarray(C_sap, np.float32)).to(engine.device).contiguous()

    def candidates(self, Q_sap: np.ndarray, kp: int, ef_search: int):
        n = self._C.shape[0]
        Q = torch.as_tensor(np.asarray(Q_sap, np.float32)).to(
            self._C.device)
        _, cand = l2_ops.knn(Q, self._C, min(kp, n),
                             chunk=min(self.chunk, n))
        valid = torch.ones(cand.shape, dtype=torch.bool, device=cand.device)
        self.last_filter_bytes = self._C.numel() * 4
        return cand, valid, Q_sap.shape[0] * n


def traverse_graph_candidates(index: HNSW, Q_sap: np.ndarray, kp: int,
                              ef_search: int):
    """Per-query host-side HNSW traversal, padded to an (nq, kp)
    rectangle.  Returns (cand, valid, n_dist_evals) as numpy arrays.

    Deprecated as a serving path: `repro_torch.graph.GraphFilter` runs
    the same walk batched over the whole query set (recall-identical at
    fixed ef).  This loop is kept as the parity oracle."""
    warnings.warn(
        "the per-query host HNSW walk is deprecated as a serving path; "
        "use repro_torch.graph.GraphFilter (batched, recall-identical at "
        "fixed ef) — the host walk remains as the parity oracle",
        DeprecationWarning, stacklevel=2)
    nq = Q_sap.shape[0]
    evals0 = index.n_dist_evals
    cand = np.zeros((nq, kp), np.int32)
    valid = np.zeros((nq, kp), bool)
    for qi in range(nq):
        ids, _ = index.search(np.asarray(Q_sap[qi]), kp,
                              ef=max(ef_search, kp))
        cand[qi, : ids.size] = ids
        valid[qi, : ids.size] = True
    return cand, valid, index.n_dist_evals - evals0


class HNSWGraphFilter:
    """Host-side HNSW traversal over DCPE ciphertexts, one query at a
    time (the paper's filter as written; the parity oracle of
    `GraphFilter`).  Only the filter loops over queries — the refine is
    batched on the engine's device regardless of backend."""

    name = "hnsw"

    def __init__(self, index: HNSW):
        self.index = index
        self.last_filter_bytes = 0

    def attach(self, C_sap: np.ndarray, engine: "SecureSearchEngine"):
        pass                      # the graph already stores its ciphertexts

    def candidates(self, Q_sap: np.ndarray, kp: int, ef_search: int):
        cand, valid, evals = traverse_graph_candidates(
            self.index, Q_sap, kp, ef_search)
        # pointer chasing re-reads per query: one full row per eval
        self.last_filter_bytes = int(evals) * Q_sap.shape[1] * 4
        return cand, valid, evals


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

class SecureSearchEngine:
    """Batched filter-and-refine over an encrypted database.

    backend: "flat" | a filter-backend instance (e.g.
    `repro_torch.graph.GraphFilter(index)` — pass the HNSW built by the
    data owner).  device: where the ciphertexts live and the search
    runs; None means the card (and raises without one), "cpu" runs the
    plain PyTorch versions.  quantization must stay None until the ADC
    slice of the port.
    """

    def __init__(self, C_sap: np.ndarray, C_dce: np.ndarray, *,
                 backend="flat", quantization: str | None = None,
                 device=None, **backend_kw):
        if quantization is not None:
            raise NotImplementedError(
                "quantized ADC filters come with the ADC slice of the port "
                "(ROADMAP Queue 1 item 6)")
        if isinstance(backend, str):
            if backend == "hnsw":
                raise ValueError(
                    "pass HNSWGraphFilter(index) explicitly: the graph is "
                    "built by the data owner, not the engine")
            if backend == "graph":
                raise ValueError(
                    "pass repro_torch.graph.GraphFilter(index) explicitly: "
                    "the graph is built by the data owner, not the engine")
            if backend == "ivf":
                raise NotImplementedError(
                    "the IVF backend comes with a later slice of the port "
                    "(ROADMAP Queue 1 item 4)")
            if backend != "flat":
                raise ValueError(f"unknown backend {backend!r}")
            backend = FlatScanFilter(**backend_kw)
        self.backend = backend
        self.device = resolve_device(device)
        self.update_database(C_sap, C_dce)

    # -------------------------------------------------------------- state

    @property
    def n(self) -> int:
        return self._C_sap.shape[0]

    def update_database(self, C_sap: np.ndarray, C_dce: np.ndarray):
        """(Re)load ciphertexts, e.g. after owner-side insert (§V-D).

        Cheap: only marks the device copies dirty; the upload happens
        lazily on the next search, so a burst of maintenance ops pays one
        refresh, not one per op."""
        self._C_sap = np.asarray(C_sap)
        self._C_dce = np.asarray(C_dce)
        self._dirty = True

    def _ensure_attached(self):
        if self._dirty:
            self._C_dce_dev = None            # free the old copy first
            self._C_dce_dev = torch.as_tensor(
                np.asarray(self._C_dce, np.float32)).to(
                self.device).contiguous()
            self.backend.attach(self._C_sap, self)
            self._dirty = False

    # ------------------------------------------------------------- search

    def search_batch(self, Q_sap: np.ndarray, T_q: np.ndarray, k: int,
                     ratio_k: float = 8.0, ef_search: int = 96,
                     refine: str = "tournament"):
        """Algorithm 2, batched: k'-ANN filter then exact DCE refine.

        Q_sap: (nq, d) DCPE query ciphertexts; T_q: (nq, 2d+16) trapdoors.
        Returns (ids (nq, k) int64, SearchStats); id -1 fills slots where
        a query had fewer than k real candidates (tiny database).
        refine: "tournament" (batched tournament, default) | "none"
        (filter-only baseline, Fig. 6).  The paper's sequential heap
        refine is per-query only — use `search(..., refine="heap")`.
        """
        t0 = time.perf_counter()
        self._ensure_attached()
        Q_sap = np.atleast_2d(np.asarray(Q_sap))
        T_q = np.atleast_2d(np.asarray(T_q))
        nq = Q_sap.shape[0]
        kp = int(max(k, round(ratio_k * k)))
        with child_span("filter", backend=self.backend.name,
                        kp=kp, nq=nq) as fsp:
            cand, valid, dist_evals = self.backend.candidates(
                Q_sap, kp, ef_search)
            fsp.set(dist_evals=int(dist_evals),
                    bytes_scanned=int(
                        getattr(self.backend, "last_filter_bytes", 0)),
                    hops=int(getattr(self.backend, "last_n_hops", 0)),
                    edges_scanned=int(
                        getattr(self.backend, "last_n_edges_scanned", 0)))
        cand = torch.as_tensor(cand, device=self.device).to(torch.int64)
        valid = torch.as_tensor(valid, device=self.device).to(torch.bool)
        if cand.shape[1] < k:       # uniform (nq, k) contract: -1 fill
            pad = (0, k - cand.shape[1])
            cand = torch.nn.functional.pad(cand, pad)
            valid = torch.nn.functional.pad(valid, pad)

        with child_span("refine", mode=refine) as rsp:
            if refine == "tournament":
                T = torch.as_tensor(np.asarray(T_q, np.float32)).to(
                    self.device)
                out = refine_candidates(self._C_dce_dev, cand, T, valid, k)
                ids = out.cpu().numpy().astype(np.int64)
                nv = valid.sum(dim=1)
                ncmp = int((nv * (nv - 1)).sum())
            elif refine == "none":          # filter-only baseline
                ids = torch.where(valid[:, :k], cand[:, :k], -1)\
                    .cpu().numpy().astype(np.int64)
                ncmp = 0
            else:
                raise ValueError(f"batched refine must be 'tournament' or "
                                 f"'none', got {refine!r}")
            rsp.set(comparisons=ncmp)

        stats = SearchStats(
            latency_s=time.perf_counter() - t0,
            filter_dist_evals=int(dist_evals),
            refine_comparisons=ncmp,
            bytes_up=Q_sap.nbytes + T_q.nbytes + 4 * nq,
            bytes_down=ids.nbytes,          # int64 ids: 8 bytes per slot
            n_queries=nq,
            backend=self.backend.name,
            filter_bytes_scanned=int(
                getattr(self.backend, "last_filter_bytes", 0)),
            n_hops=int(getattr(self.backend, "last_n_hops", 0)),
            n_edges_scanned=int(
                getattr(self.backend, "last_n_edges_scanned", 0)),
        )
        return ids, stats

    def search(self, C_sap_q: np.ndarray, T_q: np.ndarray, k: int,
               ratio_k: float = 8.0, ef_search: int = 96,
               refine: str = "tournament"):
        """Single-query search: a batch-of-one view of `search_batch`
        (identical ids by construction), plus the paper-faithful
        sequential refine mode ("heap")."""
        if refine in ("tournament", "none"):
            ids, stats = self.search_batch(
                C_sap_q[None], np.asarray(T_q)[None], k, ratio_k=ratio_k,
                ef_search=ef_search, refine=refine)
            return ids[0], stats

        if refine != "heap":
            raise ValueError(refine)
        # paper Algorithm 2: max-heap keyed by DCE comparison signs
        t0 = time.perf_counter()
        self._ensure_attached()
        kp = int(max(k, round(ratio_k * k)))
        cand, valid, dist_evals = self.backend.candidates(
            np.asarray(C_sap_q)[None], kp, ef_search)
        cand = torch.as_tensor(cand).cpu().numpy()
        valid = torch.as_tensor(valid).cpu().numpy()
        cids = cand[0][valid[0]].astype(np.int64)
        ids, ncmp = secure_knn.refine_heap(
            self._C_dce[cids], cids, np.asarray(T_q), k)
        stats = SearchStats(
            latency_s=time.perf_counter() - t0,
            filter_dist_evals=int(dist_evals),
            refine_comparisons=int(ncmp),
            bytes_up=np.asarray(C_sap_q).nbytes + np.asarray(T_q).nbytes + 4,
            bytes_down=np.asarray(ids, np.int64).nbytes,
            n_queries=1,
            backend=self.backend.name,
            filter_bytes_scanned=int(
                getattr(self.backend, "last_filter_bytes", 0)),
            n_hops=int(getattr(self.backend, "last_n_hops", 0)),
            n_edges_scanned=int(
                getattr(self.backend, "last_n_edges_scanned", 0)),
        )
        return ids, stats
