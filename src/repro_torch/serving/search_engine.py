"""Batched secure filter-and-refine engine on the card.

Counterpart of `repro.serving.search_engine`:

  filter:  a pluggable backend produces k' candidate ids per query —
             * FlatScanFilter  — exhaustive scan of the DCPE ciphertexts
               through the l2_topk CUDA kernel (distance tiles fused with
               a running top-k', one call per batch, no (nq, n) matrix
               in device memory);
             * IVFScanFilter   — partition-pruned scan: host-side coarse
               probe over DCPE ciphertext centroids, then one masked
               gather+scan over the probed rows in torch ops;
             * ADCFilter       — the flat or IVF scan over int8 / PQ codes
               of the ciphertexts; the flat kind runs the adc_topk CUDA
               kernels (scan and top-k' fused, one call per batch);
             * `repro_torch.graph.GraphFilter` — the batched HNSW walk,
               its descent and layer-0 beam search in one launch of the
               graph_expand CUDA kernel;
             * HNSWGraphFilter — the per-query host walk, kept as the
               graph filter's parity oracle.
  refine:  one batched DCE tournament over the candidate sets through the
           fused dce_comp CUDA kernel (`refine_topk`: gather, Z, win
           counts and top-k in one call) — no per-query Python loop.

`SecureSearchEngine.search` is a batch-of-one wrapper over
`search_batch`, so the per-query and batched paths return identical ids.

Privacy envelope: the engine sees only DCPE filter ciphertexts and DCE
refine ciphertexts / trapdoors — never plaintexts or true distances,
only ciphertext distances and comparison signs (the leakage proven in
the paper, §VI).  IVF centroids and ADC codebooks are keyless functions
of the DCPE ciphertexts the server already holds.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from ..core import adc_codes, secure_knn
from ..core.hnsw import HNSW
from ..core.ivf import IVFIndex
from ..device import full_fp32, resolve_device
from ..kernels.common import next_bucket, top_positions
from ..kernels.dce_comp import ops as dce_ops
from ..kernels.l2_topk import ops as l2_ops
from ..obs.trace import child_span

__all__ = ["SearchStats", "SecureSearchEngine", "FlatScanFilter",
           "IVFScanFilter", "HNSWGraphFilter", "ADCFilter",
           "refine_candidates", "layout_pools", "scan_ivf_pools",
           "pool_membership", "scan_ivf_oblivious",
           "traverse_graph_candidates"]


@dataclasses.dataclass
class SearchStats:
    """Uniform per-call search accounting (single query or batch).

    Communication model (paper §V-C): user -> server is the DCPE query
    ciphertext + DCE trapdoor + k (4 bytes); server -> user is the
    serialized id matrix — int64 ids, so 8 bytes per returned slot.
    The fields and their meaning are those of the JAX package's
    `SearchStats`; the fields of backends not ported yet stay 0 unless a
    backend sets them (`last_n_shards_down`, `last_degraded`).
    """
    latency_s: float
    filter_dist_evals: int      # ciphertext distance evaluations (filter)
    refine_comparisons: int     # DCE DistanceComp sign evaluations (refine)
    bytes_up: int
    bytes_down: int
    n_queries: int = 1
    backend: str = ""
    # true bytes the filter touched this call: full-precision rows for
    # the f32 backends, codes (+ norms / centroids) for the quantized ADC
    # backends; 0 for an empty collection
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
    id).  All tensors on one device.  One fused dce_comp call: the
    candidates' ciphertexts are read through `cand`, and neither a
    gathered copy nor the Z tensor is materialized on the card.
    """
    return dce_ops.refine_topk(C_dce, cand, T, valid, k)


# Gathered row elements per step of the pruned scan: bounds its (b, L, d)
# float block (the probed pools of a batch reach 10^5 rows at 1M rows).
_GATHER_ELEMENTS = 2 ** 27


def _masked_pruned_dists(C_sap, Q, cand, valid) -> torch.Tensor:
    """IVF filter inner loop: ciphertext distances over probed rows only.

    Same ||q||^2 - 2 q.x + ||x||^2 restructuring as the l2_topk kernel,
    with a per-query gather (each query probes different partitions) and
    an invalid-slot mask (+inf); the gather runs a few queries at a time.
    Returns the (nq, L) distances of the pool layout.
    """
    full_fp32()
    nq, L = cand.shape
    idx = cand.long()
    qn = (Q * Q).sum(-1)[:, None]
    cross = torch.empty((nq, L), dtype=torch.float32, device=Q.device)
    xn = torch.empty((nq, L), dtype=torch.float32, device=Q.device)
    step = max(1, _GATHER_ELEMENTS // max(1, L * C_sap.shape[1]))
    for s in range(0, nq, step):
        rows = C_sap[idx[s:s + step]]                    # (b, L, d)
        xn[s:s + step] = (rows * rows).sum(-1)
        cross[s:s + step] = torch.einsum("qld,qd->ql", rows, Q[s:s + step])
    return torch.where(valid, qn - 2.0 * cross + xn, float("inf"))


def _masked_pruned_scan(C_sap, Q, cand, valid, kp: int):
    """The IVF pool scan: (ids, valid) of each query's top-kp of
    `_masked_pruned_dists`."""
    pos = top_positions(_masked_pruned_dists(C_sap, Q, cand, valid), kp)
    return torch.gather(cand, 1, pos), torch.gather(valid, 1, pos)


# ---------------------------------------------------------------------------
# Filter backends.  Each returns (cand (nq, kp') int64, valid (nq, kp')
# bool, n_dist_evals) given a batch of DCPE-encrypted queries; cand and
# valid are tensors on the engine's device (the host walk's are numpy).
# ---------------------------------------------------------------------------


def layout_pools(nq: int, pools, kp: int, pool_mask=None):
    """Pad ragged probe pools to a 128-bucketed (nq, L) rectangle (host
    numpy).  The power-of-two bucket on L is the reference's: one layout,
    so candidate order (and with it exact id parity) cannot drift.
    pool_mask(p) -> bool mask lets a caller pre-invalidate pool entries
    (e.g. deleted rows)."""
    L = next_bucket(max(kp, max((p.size for p in pools), default=1), 1),
                    minimum=128)
    cand = np.zeros((nq, L), np.int32)
    valid = np.zeros((nq, L), bool)
    for qi, p in enumerate(pools):                      # id layout only
        cand[qi, : p.size] = p
        valid[qi, : p.size] = True if pool_mask is None else pool_mask(p)
    return cand, valid


def scan_ivf_pools(C_dev: torch.Tensor, Q_sap: np.ndarray, pools, kp: int,
                   pool_mask=None):
    """Lay out the probe pools and run the masked scan over C_dev (n, d)
    float32.  Returns (ids (nq, kp) int32, valid (nq, kp)) on C_dev's
    device."""
    nq = Q_sap.shape[0]
    cand, valid = layout_pools(nq, pools, kp, pool_mask)
    dev = C_dev.device
    with child_span("filter.query_prep"):
        Q = torch.as_tensor(np.asarray(Q_sap, np.float32)).to(dev)
    return _masked_pruned_scan(
        C_dev, Q, torch.from_numpy(cand).to(dev),
        torch.from_numpy(valid).to(dev), kp)


def _masked_full_dists(C_all, Q, member) -> torch.Tensor:
    """Scan-oblivious IVF filter inner loop (DESIGN.md §14): ciphertext
    distances over EVERY resident row, masked afterwards (+inf) by
    per-query pool membership, so which rows the probes selected is not
    visible in the access pattern.  Member rows get the values the
    pruned scan computes.  Returns the (nq, n) distances."""
    full_fp32()
    qn = (Q * Q).sum(-1)[:, None]
    xn = (C_all * C_all).sum(-1)[None, :]
    return torch.where(member, qn - 2.0 * Q @ C_all.T + xn, float("inf"))


def _masked_full_scan(C_all, Q, member, kp: int):
    """The oblivious scan: (ids (nq, kp) int64, valid (nq, kp)) of each
    query's top-kp of `_masked_full_dists`."""
    pos = top_positions(_masked_full_dists(C_all, Q, member), kp)
    return pos, torch.gather(member, 1, pos)


def pool_membership(nq: int, pools, bucket: int, pool_mask=None):
    """(nq, bucket) bool membership mask for the oblivious scans:
    member[qi, r] iff row r is in query qi's probe pool (and passes
    pool_mask).  Host-side layout only."""
    member = np.zeros((nq, bucket), bool)
    for qi, p in enumerate(pools):
        member[qi, p] = True if pool_mask is None else pool_mask(p)
    return member


def scan_ivf_oblivious(C_dev: torch.Tensor, Q_sap: np.ndarray, pools,
                       kp: int, pool_mask=None):
    """Oblivious twin of `scan_ivf_pools`: full-bucket masked scan over
    the resident scan array.  Returns (ids (nq, kp), valid (nq, kp)) on
    C_dev's device."""
    nq = Q_sap.shape[0]
    member = pool_membership(nq, pools, int(C_dev.shape[0]), pool_mask)
    dev = C_dev.device
    with child_span("filter.query_prep"):
        Q = torch.as_tensor(np.asarray(Q_sap, np.float32)).to(dev)
    return _masked_full_scan(C_dev, Q, torch.from_numpy(member).to(dev), kp)


class FlatScanFilter:
    """Exhaustive l2_topk scan over all DCPE ciphertexts.  `chunk` is
    the row block of the plain chunked scan that CPU tensors run."""

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
        with child_span("filter.query_prep"):
            Q = torch.as_tensor(np.asarray(Q_sap, np.float32)).to(
                self._C.device)
        _, cand = l2_ops.knn(Q, self._C, min(kp, n),
                             chunk=min(self.chunk, n))
        valid = torch.ones(cand.shape, dtype=torch.bool, device=cand.device)
        self.last_filter_bytes = self._C.numel() * 4
        return cand, valid, Q_sap.shape[0] * n


class IVFScanFilter:
    """Partition-pruned scan: coarse k-means probe + masked scan.

    The coarse quantizer is built over DCPE ciphertexts — the same privacy
    envelope as the HNSW graph (centroids are functions of ciphertexts
    only).  Probing is host-side (`IVFIndex.probe`, tiny: nq x
    n_clusters); the per-row distances run on the engine's device in
    `_masked_pruned_scan`.
    """

    name = "ivf"

    def __init__(self, n_partitions: int = 64, nprobe: int = 8,
                 seed: int = 0):
        self.n_partitions = n_partitions
        self.nprobe = nprobe
        self.seed = seed
        self.ivf: IVFIndex | None = None
        self._C = None
        self.last_filter_bytes = 0

    def attach(self, C_sap: np.ndarray, engine: "SecureSearchEngine"):
        self._C = None
        self._C = torch.as_tensor(
            np.asarray(C_sap, np.float32)).to(engine.device).contiguous()
        self.ivf = IVFIndex(n_clusters=min(self.n_partitions,
                                           C_sap.shape[0]),
                            seed=self.seed).build(C_sap)

    def candidates(self, Q_sap: np.ndarray, kp: int, ef_search: int):
        Q = np.asarray(Q_sap, np.float32)
        nq = Q.shape[0]
        pools = [self.ivf.probe(q, self.nprobe) for q in Q]
        ids, vout = scan_ivf_pools(self._C, Q, pools, kp)
        evals = sum(p.size for p in pools) \
            + nq * self.ivf.centroids.shape[0]
        d = Q.shape[1]
        self.last_filter_bytes = (sum(p.size for p in pools) * d * 4
                                  + self.ivf.centroids.nbytes)
        return ids, vout, evals


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


class ADCFilter:
    """Quantized approximate-distance filter over ciphertext codes
    (DESIGN.md §11): the flat/IVF scan at 1 byte/dim (int8) or m
    bytes/vector (pq8) instead of 4 bytes/dim.

    The backend trains its codebook *keylessly* over the DCPE filter
    ciphertexts at attach (host numpy, `core.adc`), uploads the codes
    once to the engine's device (`core.adc_codes` holds them and runs
    their scans), and **oversamples**: asked for k'
    candidates it returns k' * refine_ratio of them, so the unchanged
    exact DCE refine recovers the order that quantization blurred.

    kind="flat" streams all codes through the adc_topk CUDA kernels (one
    call per batch: `sq_adc_topk` / `pq_adc_topk`, scan and top-k'
    fused); kind="ivf" probes the same coarse quantizer as
    `IVFScanFilter` (identical pools) and runs the ADC pool scan over
    the probed rows.  The reference's `use_kernel=` option is not ported.
    """

    def __init__(self, quantization: str = "int8", kind: str = "flat", *,
                 refine_ratio: float | None = None, n_partitions: int = 64,
                 nprobe: int = 8, pq_m: int = 16, seed: int = 0):
        if quantization not in ("int8", "pq8"):
            raise ValueError(f"ADCFilter needs quantization int8|pq8, "
                             f"got {quantization!r}")
        if kind not in ("flat", "ivf"):
            raise ValueError(f"ADCFilter kind must be flat|ivf, "
                             f"got {kind!r}")
        self.quantization = quantization
        self.kind = kind
        self.name = f"adc-{kind}-{quantization}"
        self.refine_ratio = adc_codes.refine_ratio(quantization, refine_ratio)
        self.n_partitions = n_partitions
        self.nprobe = nprobe
        self.pq_m = pq_m
        self.seed = seed
        self.codes = adc_codes.make(quantization)
        self.ivf: IVFIndex | None = None
        self._ok = None
        self._n = 0
        self.last_filter_bytes = 0

    @property
    def codebook(self):
        return self.codes.codebook

    # --------------------------------------------------------- encoding

    def attach(self, C_sap: np.ndarray, engine: "SecureSearchEngine"):
        dev = engine.device
        self.codes.arrays = self._ok = None
        self._n = C_sap.shape[0]
        self.codes.train(C_sap, m=self.pq_m, seed=self.seed)
        self.codes.encode(C_sap, self._n,
                          lambda buf, axis: torch.from_numpy(buf).to(dev))
        self._ok = torch.ones(self._n, dtype=torch.bool, device=dev)
        if self.kind == "ivf":
            # the SAME coarse quantizer as IVFScanFilter — probe pools
            # are identical, only the per-row distance math changes
            self.ivf = IVFIndex(n_clusters=min(self.n_partitions,
                                               C_sap.shape[0]),
                                seed=self.seed).build(C_sap)

    def oversampled(self, kp: int) -> int:
        return adc_codes.oversampled(kp, self.refine_ratio)

    # ------------------------------------------------------- candidates

    def candidates(self, Q_sap: np.ndarray, kp: int, ef_search: int):
        Q = np.asarray(Q_sap, np.float32)
        nq = Q.shape[0]
        kp2 = min(self.oversampled(kp), self._n)
        dev = self._ok.device
        qop = self.codes.query_operand(Q, dev)
        if self.kind == "flat":
            _, idx = self.codes.knn(qop, kp2, self._ok)
            # -1 marks slots beyond the valid-row count (kp' > n); the
            # refine sees them masked, never a wrapped gather index
            valid = idx >= 0
            cand = torch.where(valid, idx, 0)
            self.last_filter_bytes = self._n * self.codes.row_bytes
            return cand, valid, nq * self._n

        pools = [self.ivf.probe(q, self.nprobe) for q in Q]
        cand, valid = layout_pools(nq, pools, kp2)
        cand = torch.from_numpy(cand).to(dev)
        valid = torch.from_numpy(valid).to(dev)
        ids, vout = self.codes.pool_scan(qop, cand, valid, kp2)
        evals = sum(p.size for p in pools) \
            + nq * self.ivf.centroids.shape[0]
        self.last_filter_bytes = (sum(p.size for p in pools)
                                  * self.codes.row_bytes
                                  + self.ivf.centroids.nbytes)
        return ids, vout, evals


_BACKENDS = {"flat": FlatScanFilter, "ivf": IVFScanFilter}


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

class SecureSearchEngine:
    """Batched filter-and-refine over an encrypted database.

    backend: "flat" | "ivf" | a filter-backend instance (e.g.
    `repro_torch.graph.GraphFilter(index)` — pass the HNSW built by the
    data owner).  quantization: None | "int8" | "pq8" — a non-None value
    swaps the string-selected flat/ivf backend for the quantized
    `ADCFilter` of the same kind; the refine is unchanged.  device: where
    the ciphertexts live and the search runs; None means the card (and
    raises without one), "cpu" runs the plain PyTorch versions.
    """

    def __init__(self, C_sap: np.ndarray, C_dce: np.ndarray, *,
                 backend="flat", quantization: str | None = None,
                 device=None, **backend_kw):
        if isinstance(backend, str):
            if backend == "hnsw":
                raise ValueError(
                    "pass HNSWGraphFilter(index) explicitly: the graph is "
                    "built by the data owner, not the engine")
            if backend == "graph":
                raise ValueError(
                    "pass repro_torch.graph.GraphFilter(index) explicitly: "
                    "the graph is built by the data owner, not the engine")
            if quantization is not None:
                if backend not in ("flat", "ivf"):
                    raise ValueError(
                        f"quantization applies to flat|ivf backends, "
                        f"not {backend!r}")
                backend = ADCFilter(quantization, kind=backend, **backend_kw)
            elif backend in _BACKENDS:
                backend = _BACKENDS[backend](**backend_kw)
            else:
                raise ValueError(f"unknown backend {backend!r}")
        elif quantization is not None:
            raise ValueError("pass quantization to the backend instance, "
                             "not the engine, when supplying one")
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
        if not self._dirty:
            return
        with child_span("engine.attach"):
            self._C_dce_dev = None            # free the old copy first
            # a backend may manage the refine array's device residency
            # itself (the runtime's mutable store ships only appended
            # rows, DESIGN.md §8); default is a full upload
            provider = getattr(self.backend, "dce_device", None)
            with child_span("engine.upload") as up:
                if provider is None:
                    C_dce = np.asarray(self._C_dce, np.float32)
                    up.set(bytes=int(C_dce.nbytes))
                    self._C_dce_dev = torch.as_tensor(C_dce).to(
                        self.device).contiguous()
                else:
                    self._C_dce_dev = provider(self._C_dce)
            with child_span("filter.attach", backend=self.backend.name,
                            bytes=int(np.asarray(self._C_sap).nbytes)):
                self.backend.attach(self._C_sap, self)
            self._dirty = False

    # ------------------------------------------------------------- search

    def search_batch(self, Q_sap: np.ndarray, T_q: np.ndarray, k: int,
                     ratio_k: float = 8.0, ef_search: int = 96,
                     refine: str = "tournament"):
        """Algorithm 2, batched: k'-ANN filter then exact DCE refine.

        Q_sap: (nq, d) DCPE query ciphertexts; T_q: (nq, 2d+16) trapdoors.
        Returns (ids (nq, k) int64, SearchStats); id -1 fills slots where
        a query had fewer than k real candidates (tiny database, sparse
        IVF probe).
        refine: "tournament" (batched tournament, default) | "none"
        (filter-only baseline, Fig. 6).  The paper's sequential heap
        refine is per-query only — use `search(..., refine="heap")`.
        """
        with child_span("engine.search_batch"):
            t0 = time.perf_counter()
            self._ensure_attached()
            Q_sap = np.atleast_2d(np.asarray(Q_sap))
            T_q = np.atleast_2d(np.asarray(T_q))
            nq = Q_sap.shape[0]
            kp = int(max(k, round(ratio_k * k)))
            with child_span("filter", backend=self.backend.name,
                            kp=kp, nq=nq) as fsp:
                fsp.device_open(self.device)
                cand, valid, dist_evals = self.backend.candidates(
                    Q_sap, kp, ef_search)
                fsp.set(dist_evals=int(dist_evals),
                        bytes_scanned=int(
                            getattr(self.backend, "last_filter_bytes", 0)),
                        hops=int(getattr(self.backend, "last_n_hops", 0)),
                        edges_scanned=int(
                            getattr(self.backend, "last_n_edges_scanned", 0)))
            cand = torch.as_tensor(cand, device=self.device).to(
                torch.int64).contiguous()
            valid = torch.as_tensor(valid, device=self.device).to(
                torch.bool).contiguous()
            if cand.shape[1] < k:       # uniform (nq, k) contract: -1 fill
                pad = (0, k - cand.shape[1])
                cand = torch.nn.functional.pad(cand, pad)
                valid = torch.nn.functional.pad(valid, pad)

            with child_span("refine", mode=refine) as rsp:
                rsp.device_open(self.device)
                if refine == "tournament":
                    T = torch.as_tensor(np.asarray(T_q, np.float32))
                    # engine.wait: where the host waits for the card's
                    # queued work (names those idle gaps, and parts them
                    # from the host's own time); a copy from pageable host
                    # memory waits for the stream, here for the filter
                    with child_span("engine.wait"):
                        T = T.to(self.device)
                    # a backend may supply its own batched refine (the
                    # sharded backend of the JAX package does); semantics
                    # are identical
                    refine_fn = getattr(self.backend, "refine_batch", None)
                    if refine_fn is None:
                        refine_fn = refine_candidates
                    out = refine_fn(self._C_dce_dev, cand, T, valid, k)
                    rsp.device_close()
                    with child_span("engine.wait"):
                        ids = out.cpu()
                    ids = ids.numpy().astype(np.int64)
                    nv = valid.sum(dim=1)
                    ncmp = (nv * (nv - 1)).sum()
                    with child_span("engine.wait"):
                        ncmp = int(ncmp)
                elif refine == "none":          # filter-only baseline
                    ids = torch.where(valid[:, :k], cand[:, :k], -1)
                    rsp.device_close()
                    with child_span("engine.wait"):
                        ids = ids.cpu()
                    ids = ids.numpy().astype(np.int64)
                    ncmp = 0
                else:
                    raise ValueError(f"batched refine must be 'tournament' or "
                                     f"'none', got {refine!r}")
                # the ids' wait has passed both spans' device end events
                fsp.device_resolve()
                rsp.device_resolve()
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
                n_shards_down=int(
                    getattr(self.backend, "last_n_shards_down", 0)),
                degraded=bool(getattr(self.backend, "last_degraded", False)),
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
            n_shards_down=int(
                getattr(self.backend, "last_n_shards_down", 0)),
            degraded=bool(getattr(self.backend, "last_degraded", False)),
        )
        return ids, stats
