"""Placement-aware sharded execution: the filter-and-refine pipeline
row-sharded over the placement devices (DESIGN.md §10), the counterpart
of `repro.serving.sharded`.

`ShardedBackend` is a drop-in engine filter backend (the same
`attach`/`candidates` protocol as `runtime.ingest.DeltaAwareBackend`,
which it subclasses), so the schedulers, tenant routing, telemetry, live
encrypted ingestion and `save`/`load` snapshots of the serving runtime
all work unchanged over a sharded collection.  Shard s lives on
placement device s (`launch.mesh.local_devices`: logical shards on one
card, or several cards of one process); each row-partitioned array is
one tensor per real device holding its shards' row blocks in shard
order, so on one card a shard's rows are a row-block view of the whole
bucket and nothing is copied.  What changes is where the scans run:

  filter (flat):  the fused l2_topk kernel (K1) once per alive shard
                  over its block, local top-k' with *global* ids
                  (`local + shard * rows_per_shard`), then a merge of
                  the S * k' (distance, id) pairs: concatenated in shard
                  order and stably sorted ascending — what the JAX
                  package's all-gather + `lax.top_k` gives (ties to the
                  lower position, which is the lower global id);
  filter (adc):   the same with the int8 (K4) or PQ (K5) fused scan,
                  whose `ok` stream carries row validity;
  filter (ivf):   coarse probing stays host-side (identical pools to the
                  single-device backend); each shard computes the pool
                  distances of the rows it owns (+inf elsewhere) and an
                  elementwise minimum over shards reassembles the full
                  (nq, L) matrix — the JAX package's `pmin`, equal to the
                  single-device masked scan element for element; the
                  scan-oblivious variants scan each shard's rows in full
                  and merge like the flat filter (torch ops);
  filter (graph): per-shard subgraphs (DESIGN.md §15) — each shard owns
                  an independent HNSW over its contiguous row block,
                  mirrored into CSR arrays of one shared (R = per, LU)
                  bucket; the graph walk (K6 for the f32 walk) runs once
                  per alive shard and the k'-per-shard results merge by
                  surrogate distance on the host;
  refine:         the engine's fused refine (K2) on the device holding
                  the DCE refine array — the candidate tensor the JAX
                  package's psum gather assembles.

Row -> shard routing is the block partition of the padded capacity
bucket: global row id r lives on shard `r // rows_per_shard`.  Ids are
the stable store row ids, so live inserts append to the tail shard(s)
and deletes tombstone in place; `shard_manifest()` reports the partition
for persistence (the per-shard manifest of a `.ppcol` snapshot).

No path adds a kernel or a build: the shards launch the kernels the
single-device backend launches, at a shard's shapes, so a warmed-up
collection serves with `jit_cache_size` flat.

Failover (repro_torch.resilience, DESIGN.md §16): every shard group
carries `n_replicas` logical replicas in a `ShardHealthRegistry`; a
group is servable while >= 1 replica is up, so killing one replica
changes nothing.  When a whole group is down the backend routes around
it: the group's launches are skipped (flat, ADC, graph), its rows are
masked out of the IVF pools, and every answer is stamped
`last_degraded` / `last_n_shards_down` for `SearchStats.degraded` /
`n_shards_down`.  Its answers equal the JAX package's masked scans.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.hnsw import HNSW
from ..graph.csr import CSRGraph
from ..graph.traverse import beam_plan
from ..kernels.common import next_bucket, top_positions
from ..kernels.l2_topk import ops as l2_ops
from ..launch.mesh import local_devices
from ..obs.trace import child_complete, current as obs_current
from ..resilience.health import ShardHealthRegistry
from . import search_engine as se
from .runtime.ingest import SENTINEL, DeltaAwareBackend, _host

__all__ = ["ShardedBackend", "RowSharded", "sharded_mesh", "shard_bucket",
           "merge_shard_topk"]


def sharded_mesh(n_shards: int, device=None) -> list[torch.device]:
    """The first `n_shards` placement devices (`launch.mesh`): the
    counterpart of the JAX package's 1-D mesh."""
    devs = local_devices(device)
    if n_shards > len(devs):
        raise ValueError(f"placement wants {n_shards} shards but only "
                         f"{len(devs)} device(s) exist (call repro_torch."
                         f"launch.mesh.force_device_count(N) to place N "
                         f"logical shards on the devices there are)")
    return devs[:n_shards]


def shard_bucket(n: int, n_shards: int, minimum: int = 256) -> int:
    """Padded row capacity: the store's power-of-two bucket, rounded up
    to a multiple of n_shards so the block partition is even.  (For the
    usual power-of-two shard counts the rounding is a no-op.)"""
    b = next_bucket(max(n, 1), minimum=minimum)
    return -(-b // n_shards) * n_shards


class RowSharded:
    """One row-partitioned array over the shards' devices.

    `parts` holds one tensor per real device with the row blocks of the
    shards it hosts, in shard order: (k * per, ...) for axis 0, and
    (k, m, per) for axis 1 (the (m, n) PQ codes), so every shard's block
    is a contiguous view.  `shape` is the logical shape of the whole
    array."""

    def __init__(self, devices: list[torch.device], parts: list, per: int,
                 axis: int, shape: tuple):
        self.devices = devices
        self.cards = list(dict.fromkeys(devices))
        self.parts = parts
        self.per = per
        self.axis = axis
        self.shape = tuple(shape)

    @classmethod
    def put(cls, devices: list[torch.device], buf: np.ndarray,
            axis: int = 0) -> "RowSharded":
        """Upload a host array, one copy per real device (blocking)."""
        S = len(devices)
        per = buf.shape[axis] // S
        cards = list(dict.fromkeys(devices))
        parts = []
        for card in cards:
            mine = [s for s in range(S) if devices[s] == card]
            if axis == 0:
                host = (buf if len(mine) == S else np.concatenate(
                    [buf[s * per:(s + 1) * per] for s in mine]))
            else:
                host = np.stack([buf[:, s * per:(s + 1) * per]
                                 for s in mine])
            parts.append(torch.from_numpy(np.ascontiguousarray(host))
                         .to(card))
        return cls(list(devices), parts, per, axis, buf.shape)

    def _slot(self, s: int):
        card = self.devices[s]
        j = sum(1 for t in range(s) if self.devices[t] == card)
        return self.parts[self.cards.index(card)], j

    def shard(self, s: int) -> torch.Tensor:
        """Shard s's block: (per, ...) rows, or (m, per) PQ codes."""
        part, j = self._slot(s)
        if self.axis == 0:
            return part[j * self.per:(j + 1) * self.per]
        return part[j]

    def write(self, lo: int, hi: int, rows: np.ndarray) -> None:
        """Copy host rows into global rows lo:hi (columns for axis 1),
        shard by shard, on each device's current stream (blocking)."""
        per = self.per
        for s in range(lo // per, -(-hi // per)):
            a, b = max(lo, s * per), min(hi, (s + 1) * per)
            if a >= b:
                continue
            view = self.shard(s)
            if self.axis == 0:
                src = rows[a - lo:b - lo]
                view[a - s * per:b - s * per].copy_(
                    torch.from_numpy(np.ascontiguousarray(src)))
            else:
                src = rows[:, a - lo:b - lo]
                view[:, a - s * per:b - s * per].copy_(
                    torch.from_numpy(np.ascontiguousarray(src)))


def merge_shard_topk(parts, width: int, nq: int,
                     home: torch.device) -> torch.Tensor:
    """Cross-shard top-k' merge of per-shard kernel results.

    parts: [(base, dists (nq, kp), ids (nq, kp))] in shard order, ids
    local to the shard and -1 where its valid rows ran out (their
    distance is the kernel's fill: +inf, or INT_BIG for int8, above every
    valid distance).  The pairs are concatenated in shard order and
    stably sorted ascending, so ties go to the lower position — the lower
    global id — as `lax.top_k` over the JAX package's all-gather keeps
    them.  -> (nq, width) int64 global ids on `home`, -1 where no
    candidate exists (exhausted slots, skipped shards)."""
    if not parts:
        return torch.full((nq, width), -1, dtype=torch.int64, device=home)
    keys = torch.cat([d.to(home) for _, d, _ in parts], dim=1)
    gids = torch.cat([torch.where(i >= 0, i + base, -1).to(home)
                      for base, _, i in parts], dim=1)
    cand = torch.gather(gids, 1, top_positions(keys, width))
    if cand.shape[1] < width:
        cand = torch.nn.functional.pad(cand, (0, width - cand.shape[1]),
                                       value=-1)
    return cand


class ShardedBackend(DeltaAwareBackend):
    """Row-sharded flat / IVF / per-shard-graph filter over a mutable
    encrypted store.

    Reuses the delta-aware host-side machinery wholesale — mutation
    hooks, tombstone masking (`_mask_alive`), the IVF centroid build and
    incremental delta assignment, the ADC codebook — and replaces only
    the device layout (`RowSharded` arrays on the placement devices) and
    the scans (one launch per alive shard, then a merge).  Engine parity
    therefore reduces to the merge, which is tested id-exact against the
    single-device path (tests/test_torch_placement.py).
    """

    def __init__(self, store, kind: str = "flat", *, n_shards: int,
                 n_replicas: int = 1, data_axis: str = "data", **kw):
        if kind not in ("flat", "ivf", "graph"):
            raise ValueError(
                f"sharded placement supports flat|ivf|graph filter "
                f"backends, not {kind!r} (the per-query host walk does "
                f"not shard; kind='graph' serves per-shard subgraphs, "
                f"DESIGN.md §3/§15)")
        self._hnsw_M = kw.get("hnsw_M", 16)
        self._hnsw_efc = kw.get("hnsw_ef_construction", 200)
        super().__init__(store, kind, **kw)
        self.n_shards = int(n_shards)
        self.axis = data_axis              # the partition's name (wire)
        self.devices = sharded_mesh(self.n_shards, self.device)
        self.name = f"sharded-{self.name}"   # sharded-<kind | adc-...>
        # failover state (DESIGN.md §16): the health registry is the one
        # mutable truth; the row mask derived from it is cached on its
        # epoch
        self.n_replicas = int(n_replicas)
        self.health = ShardHealthRegistry(self.n_shards, self.n_replicas)
        self.last_degraded = False
        self.last_n_shards_down = 0
        self._serve = np.ones(self.n_shards, bool)
        self._ru_cache = (None, None)        # (epoch, bucket) -> row_up
        # per-shard subgraph state (kind="graph", DESIGN.md §15): each
        # shard owns an independent host HNSW over its contiguous row
        # block — graph edges never cross shards, so the walk runs per
        # shard and the k'-per-shard results merge by surrogate
        # distance.  The single global host graph of the base class is
        # disabled (its eager hooks assume node id == store row id,
        # which a block partition breaks); mutations are replayed
        # shard-locally at the next attach instead.
        if kind == "graph":
            self.graph = None
        self._shard_graphs: list[HNSW] | None = None
        self._g_per = 0                    # rows per shard of the mirror
        self._g_built_n = 0                # store rows absorbed so far
        self._g_csrs: list[CSRGraph] | None = None
        self._g_dirty_sh: list[set] = []
        self._g_del_pending: list[int] = []
        self._g_neigh0_sh = self._g_neigh_up_sh = None
        self._g_ok_sh = self._g_db_sh = None

    # ------------------------------------------------------------ layout

    def _row_bucket(self, n: int) -> int:
        return shard_bucket(n, self.n_shards)

    @property
    def padded_rows(self) -> int:
        return self._row_bucket(self.store.n_total)

    def shard_manifest(self) -> list[dict]:
        """The current row -> shard block partition (persisted as the
        per-shard manifest of a sharded collection snapshot)."""
        st = self.store
        per = self.padded_rows // self.n_shards
        out = []
        for s in range(self.n_shards):
            start = min(s * per, st.n_total)
            stop = min((s + 1) * per, st.n_total)
            out.append({"shard": s, "row_start": int(start),
                        "row_stop": int(stop),
                        "n_alive": int(st.alive_view[start:stop].sum())})
        return out

    def _on_cards(self, x: np.ndarray) -> dict:
        """A host array uploaded once to each real device of the shards
        (the replicated query operand)."""
        host = torch.from_numpy(np.ascontiguousarray(x))
        return {card: host.to(card) for card in dict.fromkeys(self.devices)}

    def _adc_operand(self, Q: np.ndarray) -> dict:
        """The ADC query operand, made once, on each real device."""
        op = self.codes.query_operand(Q, self.devices[0])
        return {card: op.to(card) for card in dict.fromkeys(self.devices)}

    # ------------------------------------------------------------ attach

    def on_delete(self, row: int):
        if self.kind == "graph":
            # shard graphs sync lazily at attach (one replay per burst);
            # the store has already sentinelled the row, so a search
            # racing the replay still masks it via `_mask_alive`
            self._g_del_pending.append(int(row))
            return
        super().on_delete(row)
        if self.kind == "flat":
            # force a re-upload so the deleted row is sentinelled on
            # device too — keeps the sharded candidate sets identical to
            # the single-device backend's (which re-sentinels its main
            # tensor); ivf needs nothing: the row left its probe list
            self._scan_snapshot = (-1, -1)

    def _write_rows(self, dst, lo: int, hi: int, rows: np.ndarray,
                    axis: int = 0):
        if isinstance(dst, RowSharded):
            dst.write(lo, hi, rows)
        else:
            super()._write_rows(dst, lo, hi, rows, axis)

    def _refresh_scan_array(self, C_sap: np.ndarray):
        """Sharded replacement for the parent's scan-array refresh: one
        sentinel-padded, row-sharded array serving the flat scan, the
        ivf pool scan and the graph walk.  Same caching rule as the
        parent: insert bursts inside an unchanged bucket copy only the
        new rows into the shards' blocks; bucket growth, compaction, or
        a flat delete (which invalidates the snapshot) pay one full
        re-upload."""
        st = self.store
        bucket = self._row_bucket(st.n_total)
        snapshot = (st.main_gen, st.n_total)
        if self._C_all is not None and self._scan_snapshot == snapshot:
            return
        old_gen, old_n = self._scan_snapshot
        if (self._C_all is not None and old_gen == st.main_gen
                and 0 <= old_n <= st.n_total
                and self._C_all.shape[0] == bucket):
            self._C_all.write(old_n, st.n_total, C_sap[old_n: st.n_total])
        else:
            self._C_all = None                   # free, then upload
            buf = np.full((bucket, st.d), SENTINEL, np.float32)
            buf[: st.n_total] = C_sap
            self._C_all = RowSharded.put(self.devices, buf)
        self._scan_snapshot = snapshot

    # row-sharded residency for the ADC arrays (parent attach logic):
    # every shard streams only its codes
    def _put_rows(self, buf: np.ndarray, axis: int = 0):
        return RowSharded.put(self.devices, buf, axis)

    def attach(self, C_sap: np.ndarray, engine):
        if self.kind == "graph":
            self._attach_graph_sharded(C_sap)
            return
        if self.quantization is not None:
            if self.kind == "ivf":
                self._attach_ivf_index(C_sap)   # same pools as single
            self._attach_adc(C_sap)             # codes via our hooks
            return
        if self.kind == "ivf":
            self._attach_ivf(C_sap)       # parent logic; calls our
        else:                             # _refresh_scan_array override
            self._refresh_scan_array(C_sap)

    # ------------------------------------------- per-shard subgraphs

    def _ensure_shard_graphs(self, C_sap: np.ndarray):
        """Host-graph maintenance: one independent HNSW per shard over
        its contiguous row block (shard-local node id = row - shard
        base).  A bucket change or compaction rebuilds; otherwise the
        mutation burst replays shard-locally — appended rows insert
        into their owning tail shard(s), pending deletes repair in
        place — and only the changed rows are marked for CSR refresh."""
        st = self.store
        per = self._row_bucket(max(st.n_total, 1)) // self.n_shards
        rebuild = (self._shard_graphs is None or per != self._g_per
                   or self._attached_gen != st.main_gen)
        if rebuild:
            self._shard_graphs = [
                HNSW(dim=st.d, M=self._hnsw_M,
                     ef_construction=self._hnsw_efc, seed=self.seed + s)
                for s in range(self.n_shards)]
            self._g_per = per
            self._g_built_n = 0
            self._g_csrs = None
            self._g_dirty_sh = [set() for _ in range(self.n_shards)]
            self._g_del_pending.clear()   # tombstones replay from store
        built0 = self._g_built_n
        alive = st.alive_view
        for row in range(built0, st.n_total):
            # rows append in order, so each shard's inserts are its
            # contiguous local ids — node id == local offset by
            # construction (the sharded twin of the node==row invariant)
            s, local = divmod(row, per)
            g = self._shard_graphs[s]
            node = g.insert(C_sap[row])
            if node != local:
                raise RuntimeError(
                    f"shard {s} node id {node} != local row {local}: "
                    f"subgraph and store are desynchronized")
            dirty = self._g_dirty_sh[s]
            dirty.add(local)
            for lev in range(len(g.links)):
                nb = g.links[lev][local]
                if nb is not None:
                    dirty.update(int(v) for v in nb)
            if not alive[row]:      # tombstoned between attaches (or a
                dirty.update(g.delete(local))   # rebuild over dead rows)
        self._g_built_n = st.n_total
        for row in self._g_del_pending:
            if row < built0:        # rows >= built0 were handled above
                s, local = divmod(row, per)
                dirty = self._g_dirty_sh[s]
                dirty.add(local)
                dirty.update(self._shard_graphs[s].delete(local))
        self._g_del_pending.clear()
        self._attached_gen = st.main_gen

    def _attach_graph_sharded(self, C_sap: np.ndarray):
        """CSR mirrors + device tensors for the per-shard subgraphs.  All
        shards share one (R=per, LU) bucket, so every shard's walk has
        the same shapes."""
        st = self.store
        self._ensure_shard_graphs(C_sap)
        per = self._g_per
        graphs = self._shard_graphs
        if (self._g_csrs is None or self._g_csrs[0].R != per
                or any(not c.fits(g)
                       for c, g in zip(self._g_csrs, graphs))):
            LU = max(next_bucket(max(len(g.links) - 1, 1), minimum=4)
                     for g in graphs)
            if self._g_csrs is not None:
                LU = max(LU, self._g_csrs[0].LU)
            self._g_csrs = [CSRGraph.from_hnsw(g, R=per, LU=LU)
                            for g in graphs]
            for dirty in self._g_dirty_sh:
                dirty.clear()
        else:
            for s, (c, g) in enumerate(zip(self._g_csrs, graphs)):
                if self._g_dirty_sh[s]:
                    c.refresh_rows(g, sorted(self._g_dirty_sh[s]))
                    c.refresh_meta(g)
                    self._g_dirty_sh[s].clear()
        self._g_neigh0_sh = self._g_neigh_up_sh = None    # free first
        self._g_neigh0_sh = [torch.from_numpy(c.neigh0).to(dev)
                             for c, dev in zip(self._g_csrs, self.devices)]
        self._g_neigh_up_sh = [torch.from_numpy(c.neigh_up).to(dev)
                               for c, dev in zip(self._g_csrs,
                                                 self.devices)]
        S = self.n_shards
        if self.quantization is not None:
            self._attach_adc(C_sap)     # global codebook: surrogate
            # distances stay comparable across shards
            self._g_ok_sh = [self._adc_ok.shard(s) > 0 for s in range(S)]
            self._g_db_sh = [self.codes.shard(s) for s in range(S)]
        else:
            self._refresh_scan_array(C_sap)
            ok = np.zeros(per * S, bool)
            ok[: st.n_total] = st.alive_view
            ok_rs = RowSharded.put(self.devices, ok)
            self._g_ok_sh = [ok_rs.shard(s) for s in range(S)]
            self._g_db_sh = [(self._C_all.shard(s),) for s in range(S)]

    # ------------------------------------------- graph persistence

    def graph_arrays(self) -> dict:
        """Per-shard snapshot payload: each subgraph's `to_arrays`
        encoding under an `s<shard>__` prefix (restoring the exact
        host graphs keeps post-restore searches bit-identical — a
        rebuild would replay deletes in a different repair order)."""
        if self._shard_graphs is None:     # snapshot before first search
            self._ensure_shard_graphs(self.store.sap_view)
        out = {}
        for s, g in enumerate(self._shard_graphs):
            out.update({f"s{s}__{k}": v for k, v in
                        g.to_arrays().items()})
        return out

    def restore_graph(self, arrays: dict):
        st = self.store
        if not any(k.startswith("s0__") for k in arrays):
            # an owner-built *global* graph (EncryptedCorpus.index): a
            # single graph does not block-partition, so the service
            # builds its per-shard subgraphs over the uploaded DCPE
            # ciphertexts at the next attach (keyless-safe — the same
            # inputs the owner's build saw)
            self._shard_graphs = None
            self._attached_gen = -1
            return
        per = self._row_bucket(max(st.n_total, 1)) // self.n_shards
        graphs = []
        for s in range(self.n_shards):
            pre = f"s{s}__"
            sub = {k[len(pre):]: v for k, v in arrays.items()
                   if k.startswith(pre)}
            g = HNSW.from_arrays(sub)
            want = min(max(st.n_total - s * per, 0), per)
            if g.size != want:
                raise ValueError(
                    f"shard {s} graph has {g.size} nodes for {want} "
                    f"rows (snapshot from a different partition?)")
            graphs.append(g)
        self._shard_graphs = graphs
        self._g_per = per
        self._g_built_n = st.n_total
        self._g_csrs = None
        self._g_dirty_sh = [set() for _ in range(self.n_shards)]
        self._g_del_pending.clear()
        self._attached_gen = st.main_gen

    # ------------------------------------------------------- failover

    def _row_up(self, bucket: int) -> np.ndarray:
        """(bucket,) bool host mask: True where the row's shard group
        still has a live replica.  Cached on (health epoch, bucket) —
        the steady state never rebuilds it."""
        key = (self.health.epoch, bucket)
        if self._ru_cache[0] != key:
            per = bucket // self.n_shards
            self._ru_cache = (key,
                              np.repeat(self.health.serve_mask(), per))
        return self._ru_cache[1]

    def _pool_alive(self):
        """Probe-pool validity for the IVF paths: alive, AND (degraded
        only) the row's shard group servable — host-side composition,
        so the pool scans never change."""
        st = self.store
        if not self.last_degraded:
            return lambda p: st.alive_view[p]
        row_up = self._row_up(self._row_bucket(max(st.n_total, 1)))
        return lambda p: st.alive_view[p] & row_up[p]

    def _mask_alive(self, cand: np.ndarray, valid: np.ndarray):
        safe, v = super()._mask_alive(cand, valid)
        if self.last_degraded:
            # safety net: no id from a dead shard group survives
            row_up = self._row_up(
                self._row_bucket(max(self.store.n_total, 1)))
            v = v & row_up[safe]
        return safe, v

    def _alive_shards(self) -> list[int]:
        return [s for s in range(self.n_shards) if self._serve[s]]

    # ------------------------------------------------------- candidates

    def candidates(self, Q_sap: np.ndarray, kp: int, ef_search: int):
        self._serve = sm = self.health.serve_mask()
        self.last_n_shards_down = int(self.n_shards - int(sm.sum()))
        self.last_degraded = bool(self.last_n_shards_down)
        if self.kind == "graph":
            out = self._candidates_graph(Q_sap, kp, ef_search)
        elif self.quantization is not None:
            kp2 = self.oversampled(kp)
            if self.kind == "flat":
                out = self._candidates_adc_flat(Q_sap, kp2)
            else:
                out = self._candidates_adc_ivf(Q_sap, kp2)
        elif self.kind == "flat":
            out = self._candidates_flat(Q_sap, kp)
        else:
            out = self._candidates_ivf(Q_sap, kp)
        if obs_current() is not None:
            # obs (DESIGN.md §13): one completed child span per shard
            # under the ambient filter span, carrying the row partition
            # each shard scanned — attribution, not independent timing
            for m in self.shard_manifest():
                child_complete(f"shard{m['shard']}", shard=m["shard"],
                               row_start=m["row_start"],
                               row_stop=m["row_stop"],
                               n_alive=m["n_alive"])
        return out

    def _flat_merge(self, scan, nq: int, bucket: int, kp: int):
        """One fused scan per alive shard (`scan(s, kp_loc)` -> (dists,
        local ids)), merged to the top min(kp, bucket) global ids on
        the host; -1 where no candidate exists."""
        per = bucket // self.n_shards
        width = min(kp, bucket)
        kp_loc = min(width, per)
        parts = [(s * per, *scan(s, kp_loc)) for s in self._alive_shards()]
        cand = merge_shard_topk(parts, width, nq, self.device)
        return _host(cand).astype(np.int32)

    def _candidates_flat(self, Q_sap: np.ndarray, kp: int):
        st = self.store
        nq = Q_sap.shape[0]
        bucket = int(self._C_all.shape[0])
        per = bucket // self.n_shards
        Qd = self._on_cards(np.asarray(Q_sap, np.float32))
        cand = self._flat_merge(
            lambda s, k: l2_ops.knn(Qd[self.devices[s]],
                                    self._C_all.shard(s), k,
                                    chunk=min(4096, per)),
            nq, bucket, kp)
        safe, valid = self._mask_alive(cand, np.ones(cand.shape, bool))
        self.last_filter_bytes = bucket * st.d * 4
        return safe, valid, nq * st.n_total

    def _candidates_adc_flat(self, Q_sap: np.ndarray, kp2: int):
        st = self.store
        nq = Q_sap.shape[0]
        bucket = int(self._adc_ok.shape[0])
        qop = self._adc_operand(np.asarray(Q_sap, np.float32))
        codes, ok = self.codes, self._adc_ok
        cand = self._flat_merge(
            lambda s, k: codes.knn(qop[self.devices[s]], k, ok.shard(s),
                                   db=codes.shard(s)),
            nq, bucket, kp2)
        safe, valid = self._mask_alive(cand, np.ones(cand.shape, bool))
        self.last_filter_bytes = self._adc_code_bytes(bucket)
        return safe, valid, nq * st.n_total     # same accounting as the
        # f32 paths: rows present, incl. tombstones

    def _pool_scan(self, dists, cand: np.ndarray, valid: np.ndarray,
                   kp: int):
        """Row-sharded IVF pool scan: each shard fills the (nq, L)
        entries whose pool row it owns (`dists(s, local cand, mine)`,
        +inf elsewhere) and an elementwise minimum reassembles the full
        matrix — the single-device masked scan's values, so the top-kp
        that follows is the same."""
        per = self._row_bucket(max(self.store.n_total, 1)) // self.n_shards
        d = None
        for s in range(self.n_shards):
            loc = cand.astype(np.int64) - s * per
            mine = valid & (loc >= 0) & (loc < per)
            if not mine.any():
                continue
            dev = self.devices[s]
            ds = dists(s, torch.from_numpy(np.clip(loc, 0, per - 1)).to(dev),
                       torch.from_numpy(mine).to(dev)).to(self.device)
            d = ds if d is None else torch.minimum(d, ds)
        if d is None:
            d = torch.full(cand.shape, float("inf"), device=self.device)
        pos = _host(top_positions(d, kp))
        return (np.take_along_axis(cand, pos, axis=1),
                np.take_along_axis(valid, pos, axis=1))

    def _oblivious_scan(self, dists, member: np.ndarray, kp: int):
        """Row-sharded scan-oblivious IVF filter (DESIGN.md §14): each
        shard scans ALL of its rows for every query, masked by its
        columns of the (nq, bucket) membership matrix
        (`dists(s, member columns)`), takes a local top-kp with global
        ids, and the flat filter's merge follows.  Returns global ids;
        validity is the host-side membership lookup."""
        nq, bucket = member.shape
        per = bucket // self.n_shards
        width = min(kp, bucket)
        parts = []
        for s in range(self.n_shards):
            m = torch.from_numpy(np.ascontiguousarray(
                member[:, s * per:(s + 1) * per])).to(self.devices[s])
            d = dists(s, m)
            pos = top_positions(d, min(width, per))
            parts.append((s * per, torch.gather(d, 1, pos), pos))
        ids = _host(merge_shard_topk(parts, width, nq, self.device))
        vout = member[np.arange(nq)[:, None], np.clip(ids, 0, bucket - 1)]
        return self._mask_alive(ids.astype(np.int32), vout)

    def _candidates_adc_ivf(self, Q_sap: np.ndarray, kp2: int):
        nq = Q_sap.shape[0]
        if self.ivf is None:                  # nothing alive to probe
            return (np.zeros((nq, kp2), np.int32),
                    np.zeros((nq, kp2), bool), 0)
        Q = np.asarray(Q_sap, np.float32)
        pools = [self.ivf.probe(q, self.nprobe) for q in Q]
        pm = self._pool_alive()
        qop = self._adc_operand(Q)
        codes = self.codes
        if self.oblivious:
            bucket = int(self._adc_ok.shape[0])
            member = se.pool_membership(nq, pools, bucket, pool_mask=pm)
            ids, vout = self._oblivious_scan(
                lambda s, m: codes.oblivious_dists(
                    qop[self.devices[s]], m, db=codes.shard(s)),
                member, kp2)
            evals = nq * bucket + nq * self.ivf.centroids.shape[0]
            self.last_filter_bytes = (self._adc_code_bytes(bucket)
                                      + self.ivf.centroids.nbytes)
            return ids, vout, evals
        cand, valid = se.layout_pools(nq, pools, kp2, pool_mask=pm)
        ids, vout = self._pool_scan(
            lambda s, loc, mine: codes.pool_dists(
                qop[self.devices[s]], loc, mine, db=codes.shard(s)),
            cand, valid, kp2)
        evals = sum(p.size for p in pools) \
            + nq * self.ivf.centroids.shape[0]
        self.last_filter_bytes = (
            self._adc_code_bytes(sum(p.size for p in pools))
            + self.ivf.centroids.nbytes)
        return ids, vout, evals

    def _candidates_ivf(self, Q_sap: np.ndarray, kp: int):
        st = self.store
        nq = Q_sap.shape[0]
        if self.ivf is None:                  # nothing alive to probe
            return (np.zeros((nq, kp), np.int32),
                    np.zeros((nq, kp), bool), 0)
        Q = np.asarray(Q_sap, np.float32)
        pools = [self.ivf.probe(q, self.nprobe) for q in Q]
        pm = self._pool_alive()
        Qd = self._on_cards(Q)
        C = self._C_all
        if self.oblivious:
            bucket = int(C.shape[0])
            member = se.pool_membership(nq, pools, bucket, pool_mask=pm)
            ids, vout = self._oblivious_scan(
                lambda s, m: se._masked_full_dists(
                    C.shard(s), Qd[self.devices[s]], m),
                member, kp)
            evals = nq * bucket + nq * self.ivf.centroids.shape[0]
            self.last_filter_bytes = (bucket * st.d * 4
                                      + self.ivf.centroids.nbytes)
            return ids, vout, evals
        cand, valid = se.layout_pools(nq, pools, kp, pool_mask=pm)
        ids, vout = self._pool_scan(
            lambda s, loc, mine: se._masked_pruned_dists(
                C.shard(s), Qd[self.devices[s]], loc, mine),
            cand, valid, kp)
        evals = sum(p.size for p in pools) \
            + nq * self.ivf.centroids.shape[0]
        self.last_filter_bytes = (sum(p.size for p in pools) * st.d * 4
                                  + self.ivf.centroids.nbytes)
        return ids, vout, evals

    def _candidates_graph(self, Q_sap: np.ndarray, kp: int,
                          ef_search: int):
        """Per-shard batched walk + cross-shard k' merge.  Each shard's
        walk returns its local top-k' with surrogate distances (one
        global codebook, so the scores are comparable across shards);
        the merged candidate list is the top-k' of the (nq, S*k')
        concatenation, a stable sort on the host."""
        from ..kernels.graph_expand import ops as graph_ops
        st = self.store
        Q = np.asarray(Q_sap, np.float32)
        nq = Q.shape[0]
        per = self._g_per
        kp2 = max(1, min(self.oversampled(kp), per))
        ef_eff, ef_cap, max_hops = beam_plan(kp2, max(ef_search, kp2))
        qd = self._on_cards(Q) if self.codes is None else self._adc_operand(Q)
        alive = self._alive_shards()
        ids_p, d_p, vis_p = [], [], []
        hops_t = edges_t = 0
        for s in alive:                # a dead group has no replica to walk
            lo = s * per
            cand, cand_d, visited, hops, edges = graph_ops.graph_topk(
                self._g_neigh0_sh[s], self._g_neigh_up_sh[s],
                self._g_ok_sh[s], self._g_db_sh[s], qd[self.devices[s]],
                int(self._g_csrs[s].entry), int(ef_eff), kp=kp2,
                ef_cap=ef_cap, max_hops=max_hops,
                quant=self.quantization or "f32", oblivious=self.oblivious)
            c = _host(cand).astype(np.int32)
            ids_p.append(np.where(c >= 0, c + np.int32(lo), -1))
            d_p.append(np.where(c >= 0, _host(cand_d).astype(np.float32),
                                np.inf))
            vis_p.append(_host(visited))
            hops_t += int(hops.sum())
            edges_t += int(edges.sum())
        if not ids_p:                  # every shard group is down
            self.last_n_hops = self.last_n_edges_scanned = 0
            self.last_filter_bytes = 0
            self.last_scan_trace = np.zeros((nq, 0), bool)
            return (np.zeros((nq, kp2), np.int32),
                    np.zeros((nq, kp2), bool), 0)
        ids = np.concatenate(ids_p, axis=1)
        dists = np.concatenate(d_p, axis=1)
        order = np.argsort(dists, axis=1, kind="stable")[:, :kp2]
        cand = np.take_along_axis(ids, order, axis=1)
        safe, valid = self._mask_alive(cand, cand >= 0)
        self.last_n_hops = hops_t
        self.last_n_edges_scanned = edges_t
        row_bytes = st.d * 4 if self.codes is None else self.codes.row_bytes
        self.last_filter_bytes = (edges_t + nq * len(alive)) * row_bytes
        self.last_scan_trace = np.concatenate(vis_p, axis=1)
        return safe, valid, edges_t + nq * len(alive)
