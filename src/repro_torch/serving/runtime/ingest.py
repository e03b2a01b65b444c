"""Live encrypted ingestion: mutable ciphertext store + delta-aware
filter backend (DESIGN.md §8), the counterpart of
`repro.serving.runtime.ingest`.

Storage model — append-only rows with tombstones:

  rows:   [0 ............ n_main) [n_main ........ n_total)
           "main" region           "delta" region
           served by the base      served by a bucketed flat
           filter backend          scan (flat/IVF kinds)

  * ids are stable: a row id handed out by `append` never moves or gets
    reused.  `delete` tombstones the row (alive=False), scrubs its DCE
    ciphertext and sentinels its DCPE ciphertext; the filter masks dead
    rows out of every candidate set before refine, so a deleted id is
    never returned.
  * `compact` promotes the delta into the main region (n_main := n_total
    and a generation bump) — the expensive per-backend state (flat device
    array, IVF centroids) is rebuilt once per compaction, not per insert.
  * searches see inserts immediately: every mutation marks the engine
    dirty, and the next search's attach refreshes the (cheap) delta
    state.  A burst of mutations pays one refresh, not one per op.

`MutableEncryptedStore` is the JAX package's, verbatim (host numpy):
the same mutation sequence gives the same `state_digest()` in both
packages.  `DeltaAwareBackend` implements the engine's filter-backend
protocol (`attach` / `candidates` / `dce_device`), so
`SecureSearchEngine.search_batch` — and with it the batch-of-one parity
guarantee — works unchanged over a mutating database.  Its device
arrays are torch tensors on `device` (the card unless "cpu"), sized to
power-of-two capacity buckets: inside an unchanged bucket the rows
appended since the last refresh are copied into the tensor already held
(blocking copies from host rows that nothing mutates meanwhile), and a
new bucket frees the old tensor before the fresh one is uploaded.  The
flat scans run the l2_topk and adc_topk kernels, the graph kind the
graph_expand kernel, and the refine the dce_comp kernel (through the
engine), on the card; CPU tensors take their plain versions.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ...core import adc, adc_codes
from ...core.hnsw import HNSW
from ...core.ivf import IVFIndex
from ...device import resolve_device
from ...graph.csr import CSRGraph
from ...graph.traverse import beam_plan
from ...kernels.common import next_bucket
from ...kernels.l2_topk import ops as l2_ops
from ...obs.trace import child_complete, child_span
from .. import search_engine as se

__all__ = ["MutableEncryptedStore", "DeltaAwareBackend", "SENTINEL"]

# Far-away sentinel for dead / padded DCPE rows (same convention as the
# mesh server's pad rows): never enters a top-k' unless nothing else can.
SENTINEL = 1e9


class MutableEncryptedStore:
    """Growable per-collection ciphertext arrays with tombstones."""

    def __init__(self, d: int, cdim: int):
        self.d = d
        self.cdim = cdim
        self._C_sap = np.zeros((0, d), np.float32)
        self._C_dce = np.zeros((0, 4, cdim), np.float32)
        self._alive = np.zeros(0, bool)
        self.n_main = 0
        self.n_total = 0
        self.main_gen = 0          # bumped by compact()

    # ------------------------------------------------------------- storage

    def _grow(self, extra: int):
        need = self.n_total + extra
        if need <= self._C_sap.shape[0]:
            return
        cap = next_bucket(need, minimum=256)   # power-of-two capacity
        for name in ("_C_sap", "_C_dce", "_alive"):
            old = getattr(self, name)
            grown = np.zeros((cap,) + old.shape[1:], old.dtype)
            grown[: self.n_total] = old[: self.n_total]
            setattr(self, name, grown)

    @property
    def sap_view(self) -> np.ndarray:
        return self._C_sap[: self.n_total]

    @property
    def dce_view(self) -> np.ndarray:
        return self._C_dce[: self.n_total]

    @property
    def dce_padded_view(self) -> np.ndarray:
        """DCE rows padded (with scrubbed zeros) to the power-of-two
        capacity bucket.  The engine's refine executable is specialized
        on this array's row count, so handing it bucketed shapes means a
        growing delta recompiles once per capacity doubling, not once
        per insert burst.  Rows >= n_total are never valid candidates."""
        if self.n_total == 0:
            return self._C_dce[:0]
        return self._C_dce[: next_bucket(self.n_total, minimum=256)]

    @property
    def alive_view(self) -> np.ndarray:
        return self._alive[: self.n_total]

    @property
    def delta_size(self) -> int:
        return self.n_total - self.n_main

    @property
    def n_alive(self) -> int:
        return int(self.alive_view.sum())

    def state_digest(self) -> str:
        """SHA-256 over the logical store state — ciphertexts,
        tombstones, and region bookkeeping, excluding growth slack.  Two
        stores with equal digests answer every search identically, so
        the recovery tests assert bit-identical post-replay state with
        one string compare (repro.resilience, DESIGN.md §16)."""
        h = hashlib.sha256()
        for a in (self.sap_view, self.dce_view, self.alive_view):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(np.int64([self.n_main, self.n_total,
                           self.main_gen]).tobytes())
        return h.hexdigest()

    # ----------------------------------------------------------- mutation

    def append(self, C_sap: np.ndarray, C_dce: np.ndarray) -> np.ndarray:
        C_sap = np.atleast_2d(np.asarray(C_sap, np.float32))
        C_dce = np.asarray(C_dce, np.float32)
        m = C_sap.shape[0]
        if C_sap.shape[1] != self.d or C_dce.shape != (m, 4, self.cdim):
            raise ValueError(
                f"ciphertext shapes {C_sap.shape}/{C_dce.shape} do not "
                f"match collection dims (n={m}, d={self.d}, "
                f"cdim={self.cdim})")
        self._grow(m)
        rows = np.arange(self.n_total, self.n_total + m)
        self._C_sap[rows] = C_sap
        self._C_dce[rows] = C_dce
        self._alive[rows] = True
        self.n_total += m
        return rows

    def delete(self, row: int):
        row = int(row)
        if not (0 <= row < self.n_total) or not self._alive[row]:
            raise KeyError(f"unknown or already-deleted id {row}")
        self._alive[row] = False
        self._C_dce[row] = 0.0          # scrub refine ciphertext
        self._C_sap[row] = SENTINEL     # fall out of future filter top-k'

    def compact(self):
        """Promote delta -> main.  Ids are stable (tombstones persist);
        only per-backend acceleration state is rebuilt, on next attach."""
        n_delta = self.delta_size
        self.n_main = self.n_total
        self.main_gen += 1
        # obs (DESIGN.md §13): attaches under the collection's ambient
        # ingest span when tracing is on; no-op otherwise
        child_complete("compact", n_promoted=n_delta,
                       main_gen=self.main_gen, n_total=self.n_total)

    def restore(self, C_sap: np.ndarray, C_dce: np.ndarray,
                alive: np.ndarray, n_main: int, main_gen: int):
        """Reload a persisted snapshot into an empty store (DESIGN.md §9).

        The saved arrays already carry the tombstone encoding (SENTINEL
        DCPE rows, scrubbed DCE rows), so restoring is append + alive
        overlay + bookkeeping — row ids and the main/delta split come
        back exactly as saved, which is what makes restored searches
        bit-identical."""
        if self.n_total:
            raise RuntimeError("restore requires an empty store "
                               f"(store already holds {self.n_total} rows)")
        rows = self.append(C_sap, C_dce)
        alive = np.asarray(alive, bool)
        if alive.shape != (rows.size,):
            raise ValueError(f"alive mask shape {alive.shape} does not "
                             f"match {rows.size} restored rows")
        self._alive[: rows.size] = alive
        if not 0 <= int(n_main) <= self.n_total:
            raise ValueError(f"n_main={n_main} out of range for "
                             f"{self.n_total} rows")
        self.n_main = int(n_main)
        self.main_gen = int(main_gen)


def _host(x) -> np.ndarray:
    """A kernel output as a host numpy array (ids, masks, distances)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class DeltaAwareBackend:
    """Engine filter backend over a `MutableEncryptedStore`.

    kind="flat":  main region scanned via a cached device tensor + the
                  fused l2_topk kernel; delta region scanned via a
                  power-of-two-bucketed device buffer (sentinel-padded),
                  so a batch launches the kernel twice while the delta
                  is non-empty, at shapes that change once per bucket.
    kind="ivf":   coarse centroids built over the main region at
                  compaction; delta rows are incrementally *assigned* to
                  their nearest centroid at the next attach (no kmeans
                  rerun), so probes see inserts immediately.
    kind="hnsw":  one graph over all rows, updated eagerly by
                  `on_insert` / `on_delete` (graph node id == row id),
                  walked per query on the host (the legacy shim — the
                  batched path below supersedes it, DESIGN.md §15).
    kind="graph": the same eager host graph, but served through its
                  CSR mirror by the batched traversal (`graph_expand`
                  kernel): inserts refresh exactly the changed neighbor
                  rows of the host mirror (reserved slack slots —
                  `_row_bucket` headroom — absorb them without
                  reallocation), deletes flip `ok` validity bits (plus
                  the repaired in-neighbor rows), and a compaction or
                  bucket overflow rebuilds the mirror.  Accepts
                  quantization (ADC surrogate edge scoring) and
                  `oblivious` (the bounded-hop fixed-fanout `hardened`
                  tier); those two walks run the torch walk, as in the
                  JAX package.

    All kinds mask tombstoned rows out of the candidate validity mask, so
    the refine never returns a deleted id.

    quantization="int8"|"pq8" (flat/ivf/graph kinds) swaps the f32
    scans for the quantized ADC path (DESIGN.md §11): the backend keeps one
    capacity-bucketed code tensor over *all* rows plus an int32
    row-validity stream, so delta appends re-encode only the new rows
    at the next attach and deletes only flip validity.  The codebook is
    trained keylessly over the alive ciphertexts at first attach; a
    compaction *retrains* it when the collection has at least doubled
    since training and *reuses* it otherwise — and a codebook restored
    from a snapshot re-encodes bit-identical codes.  The filter
    oversamples k' by `refine_ratio` into the unchanged exact refine
    (core.adc).

    device: where the tensors live (None: the card, "cpu": the plain
    versions).  The JAX package's `use_kernel=` is not ported.
    """

    def __init__(self, store: MutableEncryptedStore, kind: str = "flat", *,
                 device=None, n_partitions: int = 64, nprobe: int = 8,
                 hnsw_M: int = 16, hnsw_ef_construction: int = 200,
                 delta_bucket_min: int = 128, seed: int = 0,
                 quantization: str | None = None,
                 refine_ratio: float | None = None, pq_m: int = 16,
                 oblivious: bool = False):
        if kind not in ("flat", "ivf", "hnsw", "graph"):
            raise ValueError(f"unknown backend kind {kind!r}")
        if oblivious and kind == "hnsw":
            raise ValueError("scan-oblivious filtering needs flat|ivf|"
                             "graph backends (the per-query host walk "
                             "is data-dependent by construction; "
                             "kind='graph' has the bounded-hop fixed-"
                             "fanout tier, DESIGN.md §14/§15)")
        if quantization not in adc.QUANTIZATIONS:
            raise ValueError(f"unknown quantization {quantization!r} "
                             f"(have {adc.QUANTIZATIONS})")
        if quantization is not None and kind == "hnsw":
            raise ValueError("quantization applies to flat|ivf|graph "
                             "backends (the host graph walk reads "
                             "full-precision rows)")
        self.store = store
        self.kind = kind
        self.device = resolve_device(device)
        # scan-oblivious access-pattern flattening (sec, DESIGN.md §14).
        # The flat scans are full-bucket already — the flag only
        # reroutes the IVF paths from the pooled gather scans to the
        # membership-masked full-bucket scans.
        self.oblivious = bool(oblivious)
        self.quantization = quantization
        self.name = (kind if quantization is None
                     else f"adc-{kind}-{quantization}")
        self.refine_ratio = adc_codes.refine_ratio(quantization,
                                                   refine_ratio)
        self.pq_m = pq_m
        self.n_partitions = n_partitions
        self.nprobe = nprobe
        self.delta_bucket_min = delta_bucket_min
        self.seed = seed
        self.graph = (HNSW(dim=store.d, M=hnsw_M,
                           ef_construction=hnsw_ef_construction, seed=seed)
                      if kind in ("hnsw", "graph") else None)
        self.ivf: IVFIndex | None = None
        self._assign: dict[int, int] = {}       # row -> ivf cluster
        self._ivf_built_upto = 0
        self._attached_gen = -1
        self._C_main = None       # flat: device tensor of the main region
        self._C_all = None        # ivf/graph: bucketed tensor of all rows
        self._scan_snapshot = (-1, -1)          # (main_gen, n_total) of it
        self._C_delta = None      # flat: bucketed delta device buffer
        self._delta_base = 0
        self._delta_n = 0
        self._C_dce_dev = None    # refine array device residency (all
        self._dce_snapshot = (-1, -1)    # kinds); (padded_len, n_total)
        # quantized-ADC state: codebook + bucketed code arrays over all
        # rows (`codes`) + row-validity stream (see class docstring)
        self.codes = adc_codes.make(quantization)
        self.adc_trained_gen = -1        # main_gen the codebook is for
        self._adc_ok = None
        self._adc_snapshot = (-1, -1, -1)  # (codebook id, bucket, n_total)
        # batched-graph state (kind="graph", DESIGN.md §15): the CSR
        # mirror of self.graph, its device tensors, and the dirty-row
        # set accumulated by the eager mutation hooks
        self._csr: CSRGraph | None = None
        self._g_dirty: set[int] = set()
        self._g_neigh0 = self._g_neigh_up = self._g_ok = None
        self._g_db = None
        self.last_filter_bytes = 0
        self.last_n_hops = 0
        self.last_n_edges_scanned = 0
        self.last_scan_trace: np.ndarray | None = None

    # ------------------------------------------------- mutation hooks
    # Called by the Collection under its lock, *before* the engine is
    # marked dirty — eager for graph structure, lazy for device arrays.

    def on_insert(self, rows: np.ndarray, C_sap: np.ndarray):
        if self.graph is not None:
            for row, vec in zip(rows, np.atleast_2d(C_sap)):
                node = self.graph.insert(vec)
                if node != row:     # every downstream lookup (candidates,
                    # alive mask, refine gather) depends on this equality
                    raise RuntimeError(
                        f"graph node id {node} != store row id {row}: "
                        f"graph and store are desynchronized")
                if self.kind == "graph":
                    # changed-row set of an insert: the new node plus
                    # the neighbors it linked back to (HNSW.insert only
                    # touches links[lev][node] and _add_link targets)
                    self._g_dirty.add(int(node))
                    for lev in range(len(self.graph.links)):
                        nb = self.graph.links[lev][node]
                        if nb is not None:
                            self._g_dirty.update(int(v) for v in nb)

    def on_delete(self, row: int):
        if self.graph is not None:
            repaired = self.graph.delete(row)
            if self.kind == "graph":
                self._g_dirty.add(int(row))
                self._g_dirty.update(repaired)
        if self.kind == "ivf":
            c = self._assign.pop(row, None)
            if c is not None and self.ivf is not None:
                lst = self.ivf.lists[c]
                self.ivf.lists[c] = lst[lst != row]
        if self.kind == "flat" and row < self.store.n_main:
            # re-sentinel the main device tensor; delta-region deletes
            # need no rebuild (the delta buffer is refreshed every attach)
            self._C_main = None

    # ----------------------------------------------------------- attach

    def _put(self, buf: np.ndarray) -> torch.Tensor:
        """A fresh device copy of a host buffer (blocking)."""
        return torch.from_numpy(np.ascontiguousarray(buf)).to(self.device)

    def _write_rows(self, dst: torch.Tensor, lo: int, hi: int,
                    rows: np.ndarray, axis: int = 0):
        """Copy host rows into dst[lo:hi] (dst[:, lo:hi] for axis=1) of a
        tensor already on the device.  The copy is blocking and goes to
        the device's current stream — the one the kernels launch on — so
        it lands after every earlier batch's kernels and before the next
        batch's, and the host rows may be scrubbed right after."""
        src = torch.from_numpy(np.ascontiguousarray(rows))
        if axis == 0:
            dst[lo:hi].copy_(src)
        else:
            dst[:, lo:hi].copy_(src)

    def dce_device(self, C_dce_padded: np.ndarray):
        """Device residency for the refine array (engine hook): inside an
        unchanged capacity bucket, copy only the rows appended since the
        last refresh into the tensor already held, instead of the whole
        database.  Tombstoned rows keep their stale device copy — they
        are never valid candidates, so the refine cannot observe them
        (the host copy stays scrubbed)."""
        n_total = self.store.n_total
        plen = C_dce_padded.shape[0]
        old_plen, old_n = self._dce_snapshot
        if self._C_dce_dev is not None and plen == old_plen:
            if n_total > old_n:
                self._write_rows(self._C_dce_dev, old_n, n_total,
                                 C_dce_padded[old_n: n_total])
        else:
            self._C_dce_dev = None           # free the old bucket first
            self._C_dce_dev = self._put(
                np.asarray(C_dce_padded, np.float32))
        self._dce_snapshot = (plen, n_total)
        return self._C_dce_dev

    def _row_bucket(self, n: int) -> int:
        """Padded row capacity of the bucketed scan/code tensors."""
        return next_bucket(n, minimum=256)

    # ------------------------------------------- graph persistence

    def graph_arrays(self) -> dict:
        """Persistable filter-graph payload (`Collection.snapshot`):
        the host graph's `to_arrays` encoding — which `CSRGraph
        .to_arrays` reproduces bit-for-bit, the `.ppcol` contract."""
        return self.graph.to_arrays()

    def restore_graph(self, arrays: dict):
        """Install a snapshotted filter graph (`Collection
        .load_snapshot`); the CSR mirror rebuilds on the next attach."""
        g = HNSW.from_arrays(dict(arrays))
        if g.size != self.store.n_total:
            raise ValueError(f"graph has {g.size} nodes for "
                             f"{self.store.n_total} rows")
        self.graph = g
        self._csr = None
        self._g_dirty.clear()

    # ----------------------------------------------- ADC code arrays

    @property
    def adc_codebook(self):
        return None if self.codes is None else self.codes.codebook

    def _put_rows(self, buf: np.ndarray, axis: int = 0):
        """Placement of the ADC arrays (a sharded backend's row blocks)."""
        return self._put(buf)

    def restore_adc(self, codebook, trained_gen: int):
        """Install a snapshotted codebook (Collection.load_snapshot):
        codes re-encode from the restored ciphertexts bit-identically,
        so only the codebook itself persists (DESIGN.md §11)."""
        self.codes.codebook = codebook
        self.adc_trained_gen = int(trained_gen)
        self._adc_snapshot = (-1, -1, -1)

    def _attach_adc(self, C_sap: np.ndarray):
        """Refresh codebook + code tensors (one refresh per mutation
        burst).  Retrain-or-reuse: a compaction retrains only once the
        alive set has at least doubled since training; anything else
        reuses the codebook and encodes just the appended rows."""
        st = self.store
        alive = st.alive_view
        cb = self.adc_codebook
        # retrain-or-reuse: at a compaction once the alive set doubled,
        # or at the first attach with real rows after a placeholder
        # training pass (trained_n == 0: a fully-tombstoned store has
        # no geometry to fit — its degenerate grid must never encode
        # real rows)
        stale = cb is not None and (
            (st.main_gen != self.adc_trained_gen
             and st.n_alive >= 2 * cb.trained_n)
            or (cb.trained_n == 0 and st.n_alive > 0))
        if cb is None or stale:
            rows = C_sap[alive]
            placeholder = rows.shape[0] == 0
            if placeholder:                 # fully tombstoned: keep a
                rows = np.zeros((1, st.d), np.float32)   # usable grid
            cb = self.codes.train(rows, m=self.pq_m, seed=self.seed)
            if placeholder:
                cb.trained_n = 0
            self._adc_snapshot = (-1, -1, -1)   # force full re-encode
        self.adc_trained_gen = st.main_gen

        bucket = self._row_bucket(st.n_total)
        cb_id = id(self.adc_codebook)
        old_cb, old_bucket, old_n = self._adc_snapshot
        if not (old_cb == cb_id and old_bucket == bucket):
            self.codes.encode(C_sap, bucket, self._put_rows)
        elif st.n_total > old_n:            # encode appended rows only
            self.codes.append(C_sap[old_n: st.n_total], old_n,
                              self._write_rows)
        # validity is data, not shape: refreshed every burst, so
        # deletes flip bits without touching the code tensors
        ok = np.zeros(bucket, np.int32)
        ok[: st.n_total] = alive
        if self._adc_ok is not None and self._adc_ok.shape[0] == bucket:
            self._write_rows(self._adc_ok, 0, bucket, ok)
        else:
            self._adc_ok = None
            self._adc_ok = self._put_rows(ok)
        self._adc_snapshot = (cb_id, bucket, st.n_total)

    def attach(self, C_sap: np.ndarray, engine):
        """One refresh per mutation burst (the engine attaches lazily)."""
        st = self.store
        if self.kind == "graph":
            self._attach_graph(C_sap)
            return
        if self.quantization is not None:
            if self.kind == "ivf":
                self._attach_ivf_index(C_sap)
            self._attach_adc(C_sap)
            return
        if self.kind == "flat":
            if self._attached_gen != st.main_gen or self._C_main is None:
                self._C_main = None             # free, then upload
                self._C_main = (self._put(C_sap[: st.n_main])
                                if st.n_main else None)
                self._attached_gen = st.main_gen
            dn = st.delta_size
            self._delta_base, self._delta_n = st.n_main, dn
            if dn:
                bucket = next_bucket(dn, minimum=self.delta_bucket_min)
                buf = np.full((bucket, st.d), SENTINEL, np.float32)
                buf[:dn] = C_sap[st.n_main: st.n_total]
                if (self._C_delta is not None
                        and self._C_delta.shape[0] == bucket):
                    self._write_rows(self._C_delta, 0, bucket, buf)
                else:
                    self._C_delta = None
                    self._C_delta = self._put(buf)
            else:
                self._C_delta = None
        elif self.kind == "ivf":
            self._attach_ivf(C_sap)
        # hnsw: the graph already holds its ciphertexts, nothing to refresh

    def _attach_graph(self, C_sap: np.ndarray):
        """CSR mirror + device-tensor refresh (DESIGN.md §15).

        Eager delta inserts only touched their changed host rows (the
        `_g_dirty` set), so inside an unchanged row bucket the host
        refresh is row-local — the reserved slack slots of the
        power-of-two bucket absorb appends without reallocation.  A
        compaction, a bucket overflow, or a new top layer rebuilds the
        mirror at the next bucket, exactly like every other bucketed
        array in the runtime."""
        st = self.store
        g = self.graph
        R = self._row_bucket(max(st.n_total, 1))
        rebuild = (self._csr is None or self._csr.R != R
                   or not self._csr.fits(g)
                   or self._attached_gen != st.main_gen)
        if rebuild:
            LU = next_bucket(max(len(g.links) - 1, 1), minimum=4)
            self._csr = CSRGraph.from_hnsw(g, R=R, LU=LU)
            self._attached_gen = st.main_gen
        elif self._g_dirty:
            self._csr.refresh_rows(g, sorted(self._g_dirty))
            self._csr.refresh_meta(g)
        self._g_dirty.clear()
        self._g_neigh0 = self._g_neigh_up = None
        self._g_neigh0 = self._put(self._csr.neigh0)
        self._g_neigh_up = self._put(self._csr.neigh_up)
        if self.quantization is not None:
            self._attach_adc(C_sap)    # code bucket == R (_row_bucket)
            self._g_ok = self._adc_ok > 0
            self._g_db = self.codes.arrays
        else:
            self._refresh_scan_array(C_sap)
            ok = np.zeros(R, bool)
            ok[: st.n_total] = st.alive_view
            self._g_ok = self._put(ok)
            self._g_db = (self._C_all,)

    def _attach_ivf(self, C_sap: np.ndarray):
        self._attach_ivf_index(C_sap)
        self._refresh_scan_array(C_sap)

    def _attach_ivf_index(self, C_sap: np.ndarray):
        """Coarse-quantizer maintenance only (centroid build at
        compaction + incremental delta assignment) — shared by the f32
        scan and the quantized ADC pool scan, so probe pools are
        identical across quantization settings."""
        st = self.store
        if self.ivf is None or self._attached_gen != st.main_gen:
            base_n = st.n_main if st.n_main else st.n_total
            rows = np.flatnonzero(st.alive_view[:base_n])
            if rows.size == 0:          # base region fully tombstoned:
                base_n = st.n_total     # recover by building over the delta
                rows = np.flatnonzero(st.alive_view[:base_n])
            if rows.size:
                ivf = IVFIndex(n_clusters=min(self.n_partitions, rows.size),
                               seed=self.seed).build(C_sap[rows])
                ivf.lists = [rows[l] for l in ivf.lists]   # local -> row ids
                self._assign = {int(r): c
                                for c, l in enumerate(ivf.lists) for r in l}
                self.ivf = ivf
                self._ivf_built_upto = base_n
                self._attached_gen = st.main_gen
            else:                       # nothing alive anywhere; ivf stays
                self.ivf = None         # None, so the next attach retries
                self._assign = {}
                self._ivf_built_upto = 0
        # incremental assignment: new rows join their nearest centroid —
        # no kmeans rerun, probes see inserts immediately
        if self.ivf is not None and self._ivf_built_upto < st.n_total:
            new = np.arange(self._ivf_built_upto, st.n_total)
            new = new[st.alive_view[new]]
            if new.size:
                X = C_sap[new]
                d2 = (((X[:, None, :] - self.ivf.centroids[None]) ** 2)
                      .sum(-1))
                cl = d2.argmin(1)
                for c in np.unique(cl):       # one concat per cluster
                    sel = new[cl == c]
                    self.ivf.lists[c] = np.concatenate(
                        [self.ivf.lists[c], sel])
                    for row in sel:
                        self._assign[int(row)] = int(c)
            self._ivf_built_upto = st.n_total

    def _refresh_scan_array(self, C_sap: np.ndarray):
        """Sentinel-padded capacity-bucketed device copy of all rows for
        the masked scans and the graph walk.  Cached on (main_gen,
        n_total): pure delete bursts skip the refresh entirely
        (tombstoned rows leave the probe lists eagerly and the graph's
        `ok`, so the stale scan row is unreachable), and insert bursts
        inside an unchanged bucket copy only the new rows into the
        tensor already held."""
        st = self.store
        snapshot = (st.main_gen, st.n_total)
        if self._C_all is not None and self._scan_snapshot == snapshot:
            return
        bucket = next_bucket(st.n_total, minimum=256)
        old_gen, old_n = self._scan_snapshot
        if (self._C_all is not None and old_gen == st.main_gen
                and self._C_all.shape[0] == bucket):
            self._write_rows(self._C_all, old_n, st.n_total,
                             C_sap[old_n: st.n_total])
        else:
            self._C_all = None
            buf = np.full((bucket, st.d), SENTINEL, np.float32)
            buf[: st.n_total] = C_sap
            self._C_all = self._put(buf)
        self._scan_snapshot = snapshot

    # ------------------------------------------------------- candidates

    def _mask_alive(self, cand: np.ndarray, valid: np.ndarray):
        """valid &= alive, with out-of-range ids (sentinel pad slots,
        and the ADC kernels' -1 empty-slot marker) invalidated and
        clamped so the host-side alive lookup is safe."""
        st = self.store
        in_range = (cand >= 0) & (cand < st.n_total)
        safe = np.where(in_range, cand, 0)
        return safe, valid & in_range & st.alive_view[safe]

    def oversampled(self, kp: int) -> int:
        """ADC recall model: quantized filters hand k'*refine_ratio
        candidates to the exact refine (core.adc_codes)."""
        return (adc_codes.oversampled(kp, self.refine_ratio)
                if self.codes is not None else kp)

    def candidates(self, Q_sap: np.ndarray, kp: int, ef_search: int):
        if self.kind == "graph":
            return self._candidates_graph(Q_sap, kp, ef_search)
        if self.quantization is not None:
            kp2 = self.oversampled(kp)
            if self.kind == "flat":
                return self._candidates_adc_flat(Q_sap, kp2)
            return self._candidates_adc_ivf(Q_sap, kp2)
        if self.kind == "flat":
            return self._candidates_flat(Q_sap, kp)
        if self.kind == "ivf":
            return self._candidates_ivf(Q_sap, kp)
        return self._candidates_hnsw(Q_sap, kp, ef_search)

    def _adc_code_bytes(self, rows: int) -> int:
        # codes (+ SQ norms) plus the int32 validity stream — what the
        # quantized scan actually touches per bucketed row
        return rows * (self.codes.row_bytes + 4)

    def _query_operand(self, Q: np.ndarray) -> torch.Tensor:
        """The query operand on the device: the float32 ciphertexts, or
        the ADC codes' operand (`core.adc_codes`)."""
        if self.codes is not None:
            return self.codes.query_operand(Q, self.device)
        with child_span("filter.query_prep"):
            return self._put(np.asarray(Q, np.float32))

    def _candidates_adc_flat(self, Q_sap: np.ndarray, kp2: int):
        st = self.store
        nq = Q_sap.shape[0]
        bucket = int(self._adc_ok.shape[0])
        kp2 = min(kp2, bucket)
        qop = self._query_operand(np.asarray(Q_sap, np.float32))
        _, idx = self.codes.knn(qop, kp2, self._adc_ok)
        cand = _host(idx).astype(np.int32)
        safe, valid = self._mask_alive(cand, np.ones(cand.shape, bool))
        self.last_filter_bytes = self._adc_code_bytes(bucket)
        # rows present (incl. tombstones), matching the f32 flat path's
        # main+delta accounting — evals stay comparable across
        # quantization settings
        return safe, valid, nq * st.n_total

    def _candidates_adc_ivf(self, Q_sap: np.ndarray, kp2: int):
        st = self.store
        nq = Q_sap.shape[0]
        if self.ivf is None:                  # nothing alive to probe
            return (np.zeros((nq, kp2), np.int32),
                    np.zeros((nq, kp2), bool), 0)
        Q = np.asarray(Q_sap, np.float32)
        pools = [self.ivf.probe(q, self.nprobe) for q in Q]
        qop = self._query_operand(Q)
        if self.oblivious:
            # membership-masked full-code scan (DESIGN.md §14): the
            # bucketed code tensors already span every row, so the
            # oblivious variant reuses them with a (nq, bucket) mask
            bucket = int(self._adc_ok.shape[0])
            member = self._put(se.pool_membership(
                nq, pools, bucket, pool_mask=lambda p: st.alive_view[p]))
            ids, vout = self.codes.oblivious_scan(qop, member,
                                                  min(kp2, bucket))
            ids, vout = self._mask_alive(_host(ids).astype(np.int32),
                                         _host(vout))
            evals = nq * bucket + nq * self.ivf.centroids.shape[0]
            self.last_filter_bytes = (self._adc_code_bytes(bucket)
                                      + self.ivf.centroids.nbytes)
            return ids, vout, evals
        cand, valid = se.layout_pools(nq, pools, kp2,
                                      pool_mask=lambda p: st.alive_view[p])
        ids, vout = self.codes.pool_scan(qop, self._put(cand),
                                         self._put(valid), kp2)
        evals = sum(p.size for p in pools) \
            + nq * self.ivf.centroids.shape[0]
        self.last_filter_bytes = (
            self._adc_code_bytes(sum(p.size for p in pools))
            + self.ivf.centroids.nbytes)
        return _host(ids), _host(vout), evals

    def _candidates_flat(self, Q_sap: np.ndarray, kp: int):
        """Two fused l2_topk scans a batch while the delta is non-empty
        (the main tensor and the sentinel-padded delta bucket), merged on
        the host."""
        st = self.store
        nq = Q_sap.shape[0]
        Qd = self._query_operand(Q_sap)
        parts, evals = [], 0
        if self._C_main is not None:
            n_main = int(self._C_main.shape[0])
            dist, idx = l2_ops.knn(Qd, self._C_main, min(kp, n_main),
                                   chunk=min(4096, n_main))
            cand = _host(idx).astype(np.int32)
            safe, valid = self._mask_alive(cand,
                                           np.ones(cand.shape, bool))
            parts.append((_host(dist), safe, valid))
            evals += nq * n_main
        if self._C_delta is not None:
            bucket = int(self._C_delta.shape[0])
            dist, idx = l2_ops.knn(Qd, self._C_delta, min(kp, bucket),
                                   chunk=bucket)
            raw = _host(idx).astype(np.int32)
            in_delta = raw < self._delta_n
            cand = raw + np.int32(self._delta_base)
            safe, valid = self._mask_alive(cand, in_delta)
            parts.append((_host(dist), safe, valid))
            evals += nq * self._delta_n
        self.last_filter_bytes = st.d * 4 * (
            (int(self._C_main.shape[0]) if self._C_main is not None else 0)
            + (int(self._C_delta.shape[0]) if self._C_delta is not None
               else 0))
        dists = np.concatenate([d for d, _, _ in parts], axis=1)
        cand = np.concatenate([c for _, c, _ in parts], axis=1)
        valid = np.concatenate([v for _, _, v in parts], axis=1)
        # merge main and delta blocks into one globally distance-sorted
        # list — the engine contract (refine="none" takes cand[:, :k])
        order = np.argsort(np.where(valid, dists, np.inf), axis=1,
                           kind="stable")
        return (np.take_along_axis(cand, order, axis=1),
                np.take_along_axis(valid, order, axis=1), evals)

    def _candidates_ivf(self, Q_sap: np.ndarray, kp: int):
        st = self.store
        nq = Q_sap.shape[0]
        if self.ivf is None:                      # nothing alive to probe
            return (np.zeros((nq, kp), np.int32),
                    np.zeros((nq, kp), bool), 0)
        Q = np.asarray(Q_sap, np.float32)
        pools = [self.ivf.probe(q, self.nprobe) for q in Q]
        if self.oblivious:
            # full-bucket membership-masked scan: every resident row is
            # touched for every query, so evals/bytes are constants of
            # the bucket — the access-pattern observable the hardened
            # profiles flatten (DESIGN.md §14)
            bucket = int(self._C_all.shape[0])
            ids, vout = se.scan_ivf_oblivious(
                self._C_all, Q, pools, kp,
                pool_mask=lambda p: st.alive_view[p])
            ids, vout = self._mask_alive(_host(ids), _host(vout))
            evals = nq * bucket + nq * self.ivf.centroids.shape[0]
            self.last_filter_bytes = (bucket * st.d * 4
                                      + self.ivf.centroids.nbytes)
            return ids, vout, evals
        ids, vout = se.scan_ivf_pools(
            self._C_all, Q, pools, kp,
            pool_mask=lambda p: st.alive_view[p])
        evals = sum(p.size for p in pools) + nq * self.ivf.centroids.shape[0]
        self.last_filter_bytes = (sum(p.size for p in pools) * st.d * 4
                                  + self.ivf.centroids.nbytes)
        return ids, vout, evals

    def _candidates_graph(self, Q_sap: np.ndarray, kp: int,
                          ef_search: int):
        """Batched traversal over the CSR mirror (the whole query batch
        in one call — `kernels.graph_expand.ops.graph_topk`: one
        graph_walk launch for the f32 perf walk on the card)."""
        from ...kernels.graph_expand import ops as graph_ops
        st = self.store
        Q = np.asarray(Q_sap, np.float32)
        nq = Q.shape[0]
        R = int(self._g_neigh0.shape[0])
        kp2 = max(1, min(self.oversampled(kp), R))
        ef_eff, ef_cap, max_hops = beam_plan(kp2, max(ef_search, kp2))
        qd = self._query_operand(Q)
        cand, _, visited, hops, edges = graph_ops.graph_topk(
            self._g_neigh0, self._g_neigh_up, self._g_ok, self._g_db,
            qd, int(self._csr.entry), int(ef_eff), kp=kp2, ef_cap=ef_cap,
            max_hops=max_hops, quant=self.quantization or "f32",
            oblivious=self.oblivious)
        cand = _host(cand).astype(np.int32)
        safe, valid = self._mask_alive(cand, cand >= 0)
        n_edges = int(edges.sum())
        self.last_n_hops = int(hops.sum())
        self.last_n_edges_scanned = n_edges
        row_bytes = st.d * 4 if self.codes is None else self.codes.row_bytes
        self.last_filter_bytes = (n_edges + nq) * row_bytes
        self.last_scan_trace = _host(visited)
        return safe, valid, n_edges + nq

    def _candidates_hnsw(self, Q_sap: np.ndarray, kp: int, ef_search: int):
        cand, valid, evals = se.traverse_graph_candidates(
            self.graph, Q_sap, kp, ef_search)
        safe, valid = self._mask_alive(cand, valid)
        self.last_filter_bytes = int(evals) * self.store.d * 4
        return safe, valid, evals
