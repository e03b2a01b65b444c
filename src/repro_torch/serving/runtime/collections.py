"""Multi-tenant collections: per-tenant keys, ciphertext stores, index,
engine, and batcher — with strict routing (DESIGN.md §8).  Counterpart
of `repro.serving.runtime.collections`; `device=` (None: the card,
"cpu": the plain versions) takes the place of the JAX package's
`use_kernel=`.

Tenancy model: one key pair per tenant collection (the paper's
single-owner scheme, applied per collection).  The server routes a
request to exactly the collection named by `(tenant, collection)`; a
tenant id that does not own the named collection raises
`TenantIsolationError` before any ciphertext is touched, so one tenant's
trapdoors never meet another tenant's ciphertexts.  (Even if routing
were bypassed, cross-tenant results are cryptographic garbage — keys
differ — but the runtime's guarantee is structural, not accidental.)

Role colocation note: `Collection.insert(P)` runs the *owner-side*
batched encryption in-process (`DataOwner.encrypt_vectors`, on the
collection's device) — this runtime plays both the data-owner
ingestion endpoint and the honest-but-curious search server, as in the
paper's evaluation harness.  The search/storage path only ever sees
ciphertexts; `insert_encrypted` is the wire-format entry point for a
remote owner.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ...core import dce, ppanns
from ...core.ivf import IVFIndex
from ...device import resolve_device
from ...obs.trace import NULL_RECORDER
from ..search_engine import SearchStats, SecureSearchEngine
from .batcher import MicroBatcher
from .ingest import DeltaAwareBackend, MutableEncryptedStore
from .slot_loop import SlotLoop
from .telemetry import CollectionTelemetry

__all__ = ["Collection", "CollectionManager", "TenantIsolationError",
           "SCHEDULERS"]

# The serving schedulers a collection can run its request queue on
# (DESIGN.md §12): "flush" = deadline/size micro-batching over bucketed
# shapes; "continuous" = the slot-table loop (no deadline, one shape).
SCHEDULERS = ("flush", "continuous")


class TenantIsolationError(KeyError):
    """A tenant addressed a collection it does not own (or that does not
    exist — the two cases are deliberately indistinguishable, so a
    tenant cannot enumerate other tenants' collection names)."""


class Collection:
    """One tenant's encrypted corpus: keys + store + index + engine +
    request scheduler (flush micro-batcher or continuous slot loop) +
    telemetry."""

    def __init__(self, tenant: str, name: str, d: int, *,
                 backend: str = "flat", sap_beta: float = 1.0,
                 sap_s: float = 1024.0, seed: int | None = None,
                 device=None, max_batch: int = 32,
                 max_wait_ms: float = 2.0, max_queue: int = 256,
                 compact_every: int = 4096, verify_parity: bool = False,
                 keyless: bool = False, placement=None,
                 scheduler: str = "flush", clock=None, tracer=None,
                 metrics=None, security_profile: str = "perf",
                 retry_policy=None, **backend_kw):
        self.tenant = tenant
        self.name = name
        self.d = d
        # leakage tier (repro.sec, DESIGN.md §14): resolves the profile
        # once and threads its knobs into the layers that implement it —
        # oblivious scan variants into the backend, the dummy-padding
        # policy into the scheduler.  Result-width padding happens in
        # the API layer (repro.api.roles), which reads the same profile
        # off its IndexSpec.
        from ...sec import get_profile
        # the card unless the caller asks for "cpu"; with an explicit
        # index, so the scheduler's worker thread never depends on its
        # own current device
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.security_profile = get_profile(security_profile)
        if self.security_profile.oblivious:
            backend_kw["oblivious"] = True
        # obs (DESIGN.md §13): tracer = repro.obs.TraceRecorder (request/
        # batch/ingest span trees), metrics = repro.obs.MetricsRegistry
        # (cross-collection Prometheus instruments).  Both default off.
        self.tracer = tracer
        self._ingest_seq = 0
        if seed is None:
            # fresh entropy per collection: two tenants must never derive
            # the same key pair just because neither passed a seed
            seed = int(np.random.SeedSequence().entropy % (2 ** 31))
        self.seed = seed          # effective seed — recorded by save()
        # keyless = the honest-but-curious server's view (repro.api): the
        # collection holds ciphertexts only; keys live with the remote
        # DataOwnerClient and plaintext ingestion is structurally absent
        self.owner = None if keyless else ppanns.DataOwner(
            d=d, sap_beta=sap_beta, sap_s=sap_s, seed=seed)
        self.store = MutableEncryptedStore(d, dce.ciphertext_dim(d))
        # placement chooses WHERE the engine executes (DESIGN.md §10):
        # None/"single" -> the delta-aware single-device backend,
        # "sharded"     -> row-sharded scans over the placement devices
        # (`launch.mesh`), one launch per shard + a merge.  Everything
        # above the backend (batcher, ingestion, telemetry, snapshots)
        # is placement-agnostic.
        self.placement = placement
        if placement is not None and placement.kind == "sharded":
            from ..sharded import ShardedBackend
            if placement.n_shards is None:
                raise ValueError("sharded placement must be resolved "
                                 "(n_shards pinned) before it reaches "
                                 "the runtime")
            self._backend = ShardedBackend(
                self.store, backend, n_shards=placement.n_shards,
                n_replicas=getattr(placement, "n_replicas", 1),
                data_axis=placement.data_axis, device=self.device,
                seed=seed, **backend_kw)
        else:
            self._backend = DeltaAwareBackend(self.store, backend,
                                              device=self.device,
                                              seed=seed, **backend_kw)
        self._engine: SecureSearchEngine | None = None
        self._lock = threading.RLock()
        self.compact_every = int(compact_every)
        # crash-safe ingestion (repro.resilience, DESIGN.md §16): when a
        # WAL is attached every acknowledged mutation is fsync'd before
        # the call returns.  Duck-typed (any object with .append/
        # .last_seq) so the runtime never imports repro.resilience.
        self._wal = None
        # telemetry runs on the same injected clock as the scheduler, so
        # its QPS windows / sojourns live on one (virtual) timeline
        self.telemetry = CollectionTelemetry(
            clock=clock, metrics=metrics,
            labels={"tenant": tenant, "collection": name})
        # scheduler chooses HOW concurrent requests share engine calls
        # (DESIGN.md §12) — orthogonal to placement, which chooses WHERE
        # the engine executes; `self.batcher` keeps its name as the
        # client-facing Scheduler handle either way.
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r} "
                             f"(have {SCHEDULERS})")
        self.scheduler = scheduler
        pad_policy = self.security_profile.pad_policy
        if scheduler == "continuous":
            self.batcher = SlotLoop(
                self._run_batch, max_batch=max_batch, max_queue=max_queue,
                d=d, cdim=dce.ciphertext_dim(d), telemetry=self.telemetry,
                verify_parity=verify_parity, verify_lock=self._lock,
                clock=clock, name=f"{tenant}/{name}", tracer=tracer,
                pad_policy=pad_policy, retry_policy=retry_policy)
        else:
            self.batcher = MicroBatcher(
                self._run_batch, max_batch=max_batch,
                max_wait_ms=max_wait_ms, max_queue=max_queue,
                telemetry=self.telemetry, verify_parity=verify_parity,
                verify_lock=self._lock, clock=clock,
                name=f"{tenant}/{name}", tracer=tracer,
                pad_policy=pad_policy, retry_policy=retry_policy)

    # ------------------------------------------------------------ keys

    def new_user(self) -> ppanns.User:
        """Owner -> trusted user key handoff for this collection."""
        if self.owner is None:
            raise RuntimeError(
                f"collection {self.tenant}/{self.name} is keyless "
                "(server-side): keys live with the DataOwnerClient")
        return ppanns.User(self.owner.share_keys())

    # ------------------------------------------------------ durability

    def attach_wal(self, wal):
        """Attach a write-ahead log (repro.resilience.WriteAheadLog or
        anything shaped like it).  From here on, every acknowledged
        insert/delete/explicit-compact appends a ciphertext-only record
        under the collection lock — applied first, logged second, acked
        third — so `repro.resilience.recover` replays exactly the
        mutations callers saw succeed.  Auto-compaction is NOT logged:
        replay re-triggers it deterministically at the same
        `compact_every` threshold."""
        self._wal = wal

    @property
    def health(self):
        """The sharded backend's ShardHealthRegistry (None for single
        placement — there is no replica to fail over to)."""
        return getattr(self._backend, "health", None)

    def _wal_append(self, op: str, arrays=None):
        """Log one applied mutation (caller holds `_lock`)."""
        if self._wal is not None:
            self._wal.append(op, arrays)
            self.telemetry.record_wal()

    # ------------------------------------------------------- ingestion

    def _ingest_span(self, op: str):
        """One trace per ingest operation (DESIGN.md §13): a root span
        the store's compaction hook attaches under via the ambient
        context.  A shared no-op span when tracing is off."""
        if self.tracer is None:
            return NULL_RECORDER.span(op, "")
        tid = f"{self.tenant}/{self.name}:i{self._ingest_seq}"
        self._ingest_seq += 1
        return self.tracer.span(
            op, tid, collection=f"{self.tenant}/{self.name}")

    def insert(self, P: np.ndarray) -> np.ndarray:
        """Owner-side API: batch-encrypt plaintext vectors (the DCPE +
        DCE encryptors, on the collection's device) and append.  Returns
        the stable row ids."""
        if self.owner is None:
            raise RuntimeError(
                f"collection {self.tenant}/{self.name} is keyless "
                "(server-side): ingest ciphertexts via insert_encrypted")
        C_sap, C_dce = self.owner.encrypt_vectors(P, device=self.device)
        return self.insert_encrypted(C_sap, C_dce)

    def insert_encrypted(self, C_sap: np.ndarray,
                         C_dce: np.ndarray) -> np.ndarray:
        """Server-side API: append pre-encrypted rows (wire format)."""
        with self._ingest_span("insert") as sp, self._lock:
            rows = self.store.append(C_sap, C_dce)
            self._backend.on_insert(rows, C_sap)
            compacted = False
            if self.store.delta_size >= self.compact_every:
                self.store.compact()
                compacted = True
            self._refresh_engine()
            # durability point (DESIGN.md §16): log the STORE's copy of
            # the rows (normalized dtypes/layout), so replay through
            # this same method reconstructs bit-identical state; fsync
            # happens inside append, before the ack below
            self._wal_append("insert", {
                "C_sap": self.store.sap_view[rows].copy(),
                "C_dce": self.store.dce_view[rows].copy()})
            sp.set(n_rows=len(rows), compacted=compacted)
        self.telemetry.record_ingest(n_inserted=len(rows),
                                     compacted=compacted)
        return rows

    def delete(self, ids) -> int:
        """Tombstone rows; searches issued after this never return them.
        All-or-nothing: every id is validated before the first mutation,
        so a bad id cannot leave the batch half-applied (and the engine
        is re-marked dirty even if a backend hook fails mid-way)."""
        rows = [int(r) for r in np.atleast_1d(np.asarray(ids, np.int64))]
        with self._ingest_span("delete") as sp, self._lock:
            sp.set(n_rows=len(rows))
            seen: set[int] = set()
            for row in rows:
                if row in seen or not (0 <= row < self.store.n_total) \
                        or not self.store.alive_view[row]:
                    raise KeyError(
                        f"unknown, duplicate, or already-deleted id {row}")
                seen.add(row)
            try:
                for row in rows:
                    self.store.delete(row)
                    self._backend.on_delete(row)
            finally:
                self._refresh_engine()
            # reached only when every row applied — a mid-batch hook
            # failure raises above, and an unacked mutation must never
            # be replayed as if the caller saw it succeed
            self._wal_append("delete",
                             {"rows": np.asarray(rows, np.int64)})
        self.telemetry.record_ingest(n_deleted=len(rows))
        return len(rows)

    def compact(self):
        with self._ingest_span("compact"), self._lock:
            self.store.compact()
            self._refresh_engine()
            # an EXPLICIT compact is an acknowledged state transition
            # (main_gen bump) a replay cannot re-derive from thresholds
            self._wal_append("compact")
        self.telemetry.record_ingest(compacted=True)

    def load_snapshot(self, C_sap: np.ndarray, C_dce: np.ndarray, *,
                      alive: np.ndarray | None = None, n_main: int = -1,
                      main_gen: int = 1, graph_arrays: dict | None = None,
                      ivf_state: dict | None = None,
                      adc_state: dict | None = None):
        """Load pre-encrypted rows — an owner-uploaded corpus or a
        persisted collection snapshot — into this (empty) collection
        without re-running per-row ingestion (DESIGN.md §9).

        For an hnsw-backed collection the filter graph comes in as
        `graph_arrays` (`HNSW.to_arrays` payload — built by the data
        owner over DCPE ciphertexts, or saved by a previous service
        incarnation); node ids must equal row ids.  flat/ivf backends
        rebuild their (deterministic, seed-keyed) acceleration state
        lazily on the next search.  Returns the row ids."""
        C_sap = np.atleast_2d(np.asarray(C_sap, np.float32))
        n = C_sap.shape[0]
        if alive is None:
            alive = np.ones(n, bool)
        if n_main < 0:
            n_main = n            # an uploaded corpus is all main region
        with self._ingest_span("load_snapshot") as sp, self._lock:
            sp.set(n_rows=n)
            self.store.restore(C_sap, C_dce, alive, n_main, main_gen)
            if self._backend.kind in ("hnsw", "graph"):
                if graph_arrays is None:
                    raise ValueError(
                        "hnsw/graph-backed collection needs the filter "
                        "graph (HNSW.to_arrays payload) alongside the "
                        "ciphertexts")
                self._backend.restore_graph(dict(graph_arrays))
            elif self._backend.kind == "ivf" and ivf_state is not None:
                # restore the IVF index exactly as snapshotted: its
                # centroids depend on which rows were alive at build
                # time, which a fresh kmeans over today's survivors
                # would not reproduce
                cent = np.asarray(ivf_state["centroids"], np.float32)
                offs = np.asarray(ivf_state["list_offsets"], np.int64)
                flat = np.asarray(ivf_state["list_flat"], np.int64)
                ivf = IVFIndex(n_clusters=cent.shape[0], seed=self.seed)
                ivf.centroids = cent
                ivf.lists = [flat[offs[i]: offs[i + 1]].copy()
                             for i in range(offs.size - 1)]
                b = self._backend
                b.ivf = ivf
                b._assign = {int(r): c
                             for c, l in enumerate(ivf.lists) for r in l}
                b._ivf_built_upto = int(ivf_state["built_upto"])
                b._attached_gen = int(ivf_state["attached_gen"])
            if adc_state is not None:
                # restore the exact codebook the snapshot was trained
                # with (its grid/centroids depend on the rows alive at
                # training time); the codes re-encode bit-identically
                # from the restored ciphertexts (DESIGN.md §11)
                from ...core import adc as adc_mod
                codebook = adc_mod.codebook_from_arrays(
                    self._backend.quantization, adc_state["arrays"])
                self._backend.restore_adc(
                    codebook, int(adc_state["trained_gen"]))
            self._refresh_engine()
        self.telemetry.record_ingest(n_inserted=n)
        return np.arange(n)

    def _refresh_engine(self):
        """Mark engine state dirty; the rebuild happens lazily on the next
        search, so a burst of mutations pays one refresh (DESIGN.md §8)."""
        if self._engine is None:
            if self.store.n_total:
                self._engine = SecureSearchEngine(
                    self.store.sap_view, self.store.dce_padded_view,
                    backend=self._backend, device=self.device)
        else:
            self._engine.update_database(self.store.sap_view,
                                         self.store.dce_padded_view)

    def snapshot(self) -> tuple[dict, dict]:
        """Persistable state: (arrays, bookkeeping) — the ciphertext
        store with its tombstone encoding plus the filter state that is
        NOT a pure function of the store: the hnsw graph (prefixed
        `graph__`) and the live IVF index (prefixed `ivf__` — its
        centroids were fit over the rows alive *at build time*, so a
        rebuild after later deletes would not reproduce it).  Key
        material is never part of a snapshot (a keyless collection has
        none to begin with); feed the output back through
        `load_snapshot` to restore bit-identical search behaviour
        (DESIGN.md §9).  Every array is copied under the lock — a
        concurrent mutation cannot tear the payload."""
        with self._lock:
            st = self.store
            arrays = {"C_sap": st.sap_view.copy(),
                      "C_dce": st.dce_view.copy(),
                      "alive": st.alive_view.copy()}
            bookkeeping = {"n_main": st.n_main, "main_gen": st.main_gen}
            if self._backend.kind in ("hnsw", "graph"):
                arrays.update({f"graph__{k}": np.array(v) for k, v in
                               self._backend.graph_arrays().items()})
            elif self._backend.kind == "ivf" \
                    and self._backend.ivf is not None:
                ivf = self._backend.ivf
                lists = [np.asarray(l, np.int64) for l in ivf.lists]
                offsets = np.zeros(len(lists) + 1, np.int64)
                np.cumsum([l.size for l in lists], out=offsets[1:])
                arrays.update({
                    "ivf__centroids": np.array(ivf.centroids, np.float32),
                    "ivf__list_flat": (np.concatenate(lists) if lists
                                       else np.zeros(0, np.int64)),
                    "ivf__list_offsets": offsets,
                })
                bookkeeping["ivf_built_upto"] = \
                    int(self._backend._ivf_built_upto)
                bookkeeping["ivf_attached_gen"] = \
                    int(self._backend._attached_gen)
            if getattr(self._backend, "adc_codebook", None) is not None:
                # quantized collections persist the codebook (codes are
                # a deterministic function of ciphertexts + codebook,
                # so they re-derive bit-identically on load)
                arrays.update({f"adc__{k}": np.asarray(v) for k, v in
                               self._backend.adc_codebook.to_arrays()
                               .items()})
                bookkeeping["adc_trained_gen"] = \
                    int(self._backend.adc_trained_gen)
            if self._wal is not None:
                # captured under the SAME lock hold as the array copies:
                # this snapshot contains exactly the mutations logged
                # through wal seq <= wal_seq, so recovery replays only
                # records after it and the WAL prefix can be truncated
                bookkeeping["wal_seq"] = int(self._wal.last_seq)
            manifest_fn = getattr(self._backend, "shard_manifest", None)
            if manifest_fn is not None:
                # computed under the SAME lock hold as the array copies,
                # so the persisted manifest describes exactly the store
                # state the snapshot captured — a concurrent insert
                # cannot wedge between them
                bookkeeping["shard_manifest"] = manifest_fn()
        return arrays, bookkeeping

    def shard_manifest(self) -> list[dict] | None:
        """Per-shard row partition of a sharded collection (None for
        single placement) — observability; `snapshot()` embeds its own
        lock-consistent copy for persistence."""
        fn = getattr(self._backend, "shard_manifest", None)
        if fn is None:
            return None
        with self._lock:
            return fn()

    # ---------------------------------------------------------- search

    def _run_batch(self, Q, T, k, ratio_k=8.0, ef_search=96,
                   refine="tournament"):
        """The batcher's flush target: one locked engine call."""
        with self._lock:
            if self._engine is None:            # empty collection
                nq = np.atleast_2d(Q).shape[0]
                health = getattr(self._backend, "health", None)
                down = (health.n_groups_down if health is not None
                        else 0)
                return (np.full((nq, k), -1, np.int64),
                        SearchStats(latency_s=0.0, filter_dist_evals=0,
                                    refine_comparisons=0, bytes_up=0,
                                    bytes_down=0, n_queries=nq,
                                    backend=self._backend.name,
                                    n_shards_down=down,
                                    degraded=bool(down)))
            return self._engine.search_batch(Q, T, k, ratio_k=ratio_k,
                                             ef_search=ef_search,
                                             refine=refine)

    def submit(self, C_sap_q, T_q, k, *, ratio_k: float = 8.0,
               ef_search: int = 96, want_stats: bool = False,
               trace_id: str | None = None):
        """Async single query through the micro-batcher -> Future[(k,) ids]
        (or Future[(ids, flush SearchStats)] with want_stats)."""
        C_sap_q = np.asarray(C_sap_q)
        T_q = np.asarray(T_q)
        if C_sap_q.shape != (self.d,) or \
                T_q.shape != (dce.ciphertext_dim(self.d),):
            raise ValueError(
                f"query shapes {C_sap_q.shape}/{T_q.shape} do not match "
                f"collection (d={self.d}, cdim={dce.ciphertext_dim(self.d)})")
        return self.batcher.submit(C_sap_q, T_q, k, ratio_k=ratio_k,
                                   ef_search=ef_search,
                                   want_stats=want_stats,
                                   trace_id=trace_id)

    def search(self, C_sap_q, T_q, k, *, ratio_k: float = 8.0,
               ef_search: int = 96, timeout: float | None = 30.0):
        """Sync single query through the micro-batcher."""
        return self.submit(C_sap_q, T_q, k, ratio_k=ratio_k,
                           ef_search=ef_search).result(timeout=timeout)

    def search_batch(self, Q, T, k, **kw):
        """Bulk client path: straight to the engine (still locked)."""
        return self._run_batch(Q, T, k, **kw)

    def warmup(self, k: int = 10, *, ratio_k: float = 8.0,
               ef_search: int = 96):
        """Run every bucketed batch shape against the current store.  On
        the card the first launch also builds and loads the kernel
        library (once a process), so no user request pays for it."""
        zq = np.zeros(self.d, np.float32)
        zt = np.zeros(dce.ciphertext_dim(self.d), np.float32)
        self.batcher.warmup(zq, zt, k, ratio_k=ratio_k, ef_search=ef_search)

    # ------------------------------------------------------------- misc

    def stats(self) -> dict:
        snap = self.telemetry.snapshot()
        snap.update(tenant=self.tenant, collection=self.name,
                    scheduler=self.scheduler,
                    security_profile=self.security_profile.name,
                    n_total=self.store.n_total, n_alive=self.store.n_alive,
                    n_delta=self.store.delta_size)
        return snap

    def close(self):
        self.batcher.close()


class CollectionManager:
    """Routing front door: (tenant, collection) -> Collection, strictly."""

    def __init__(self, **default_kw):
        # the collections' default device: the card unless "cpu" — a
        # manager on a host without a card refuses here, before any
        # collection is made
        resolve_device(default_kw.get("device"))
        self._default_kw = default_kw
        self._collections: dict[tuple[str, str], Collection] = {}
        self._creating: set[tuple[str, str]] = set()
        self._lock = threading.Lock()

    def create_collection(self, tenant: str, name: str, d: int,
                          **kw) -> Collection:
        """Construction (keygen QR at O((2d+16)^2), index state, batcher
        thread) runs *outside* the routing lock — one tenant creating a
        big collection must not stall every other tenant's requests."""
        merged = {**self._default_kw, **kw}
        key = (tenant, name)
        with self._lock:
            if key in self._collections or key in self._creating:
                raise ValueError(f"collection {tenant}/{name} exists")
            self._creating.add(key)
        try:
            col = Collection(tenant, name, d, **merged)
            with self._lock:
                self._collections[key] = col
            return col
        finally:
            with self._lock:
                self._creating.discard(key)

    def collection(self, tenant: str, name: str) -> Collection:
        with self._lock:
            col = self._collections.get((tenant, name))
            if col is None:
                # one error for "owned by someone else" and "nonexistent":
                # anything else is a name-enumeration oracle across tenants
                raise TenantIsolationError(
                    f"no collection {name!r} for tenant {tenant!r}")
            return col

    # thin routed delegates -------------------------------------------------

    def insert(self, tenant, name, P):
        return self.collection(tenant, name).insert(P)

    def delete(self, tenant, name, ids):
        return self.collection(tenant, name).delete(ids)

    def submit(self, tenant, name, C_sap_q, T_q, k, **kw):
        return self.collection(tenant, name).submit(C_sap_q, T_q, k, **kw)

    def search(self, tenant, name, C_sap_q, T_q, k, **kw):
        return self.collection(tenant, name).search(C_sap_q, T_q, k, **kw)

    def stats(self, tenant, name):
        return self.collection(tenant, name).stats()

    def drop_collection(self, tenant, name):
        with self._lock:
            col = self._collections.pop((tenant, name), None)
        if col is None:
            raise KeyError(f"no collection {tenant}/{name}")
        col.close()

    def close(self):
        with self._lock:
            cols = list(self._collections.values())
            self._collections.clear()
        for col in cols:
            col.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
