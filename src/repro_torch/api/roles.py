"""Role-typed clients and service (DESIGN.md §9), the counterpart of
`repro.api.roles` — the paper's three roles (Fig. 1) as first-class API
objects:

  DataOwnerClient   holds the secret keys: keygen, corpus encryption,
                    IndexSpec-driven index build, key export/import
                    through the on-disk `Keystore`.
  QueryClient       trusted user: per-query O(d^2) encryption into an
                    `EncryptedQuery`, result post-processing.
  SecureAnnService  the honest-but-curious server: wraps the runtime's
                    `CollectionManager` + request scheduler behind
                    `create_collection(IndexSpec)` and
                    `submit(SearchRequest) -> SearchResult`, and can
                    `save`/`load` its collections — ciphertexts and
                    filter graphs only, never keys — so it survives
                    restarts.

Every payload that crosses between the roles is one of the protocol
types (`protocol.py`), so owner, user, and service can live in three
different processes — or in the two packages: a `.ppcol` file or a
frame written by the JAX package is read here, and the reverse.

Device work runs on the card unless the caller passes `device="cpu"`:
the owner's batched `encrypt_vectors` and every collection of a
`SecureAnnService` (its engine, filters and refine).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import threading
import urllib.parse

import numpy as np

from ..core import ppanns
from ..core.wireformat import WireFormatError, pack, unpack
from ..obs import Observability
from ..sec import DEFAULT_PROFILE, get_profile
from ..serving.runtime import CollectionManager, QueueFullError  # noqa: F401
from ..serving.runtime import TenantIsolationError               # noqa: F401
from ..serving.runtime.collections import Collection
from .keystore import Keystore
from .protocol import (PROTOCOL_VERSION, EncryptedCorpus, EncryptedQuery,
                       IndexSpec, PlacementSpec, SearchParams,
                       SearchRequest, SearchResult)

__all__ = ["DataOwnerClient", "QueryClient", "SecureAnnService",
           "TenantIsolationError", "QueueFullError"]

_COLLECTION_SUFFIX = ".ppcol"


# ---------------------------------------------------------------------------
# Data owner.
# ---------------------------------------------------------------------------

class DataOwnerClient:
    """The key-holding role.  Created from an `IndexSpec` (keygen) or
    from previously exported keys; everything it hands to the service is
    ciphertext."""

    def __init__(self, spec: IndexSpec, *, keys: ppanns.Keys | None = None):
        spec.validate()
        self.spec = spec
        if spec.seed is None:
            # fresh entropy per owner: two owners must never derive the
            # same key pair just because neither pinned a seed
            seed = int(np.random.SeedSequence().entropy % (2 ** 31))
        else:
            seed = int(spec.seed)
        if keys is None:
            self._owner = ppanns.DataOwner(
                d=spec.d, sap_beta=spec.sap_beta, sap_s=spec.sap_s,
                seed=seed)
        else:
            if keys.d != spec.d:
                raise WireFormatError(
                    f"keys are for d={keys.d}, spec has d={spec.d}")
            self._owner = ppanns.DataOwner.from_keys(keys, seed=seed)
        self._seed = seed

    # ------------------------------------------------------------- keys

    @property
    def keys(self) -> ppanns.Keys:
        return self._owner.keys

    def share_keys(self) -> ppanns.Keys:
        """Owner -> trusted user key handoff (threat model §II-B)."""
        return self._owner.keys

    def query_client(self, seed: int | None = None) -> "QueryClient":
        return QueryClient(self.share_keys(), seed=seed)

    def export_keys(self, keystore: Keystore | str | os.PathLike,
                    name: str | None = None) -> pathlib.Path:
        """Write this owner's keys into an on-disk keystore (owner-side
        storage — the service never sees this directory)."""
        if not isinstance(keystore, Keystore):
            keystore = Keystore(keystore)
        return keystore.save(name or f"{self.spec.tenant}__{self.spec.name}",
                             self.keys)

    @classmethod
    def from_keystore(cls, spec: IndexSpec,
                      keystore: Keystore | str | os.PathLike,
                      name: str | None = None) -> "DataOwnerClient":
        if not isinstance(keystore, Keystore):
            keystore = Keystore(keystore)
        keys = keystore.load(name or f"{spec.tenant}__{spec.name}",
                             expect_d=spec.d)
        return cls(spec, keys=keys)

    # ------------------------------------------------------- encryption

    def encrypt_vectors(self, P: np.ndarray, seed: int | None = None,
                        device=None) -> tuple[np.ndarray, np.ndarray]:
        """Streaming-ingest encryption on the device (bucketed DCPE +
        DCE, `DataOwner.encrypt_vectors`; `device=None` means the card).
        Returns (C_sap (m, d), C_dce (m, 4, 2d+16)) ready for
        `SecureAnnService.insert`."""
        return self._owner.encrypt_vectors(P, seed=seed, device=device)

    def encrypt_corpus(self, P: np.ndarray, *, progress_every: int = 0
                       ) -> EncryptedCorpus:
        """Bulk outsourcing (paper §V-A): encrypt the whole database and
        — when the spec's backend is "hnsw" or "graph" — build the
        filter graph over the DCPE ciphertexts.  Delegates to
        `DataOwner.encrypt_database` (host numpy, the JAX package's
        schedule), so the same seed gives the same ciphertexts and graph
        in both packages."""
        P = np.atleast_2d(np.asarray(P))
        if P.shape[1] != self.spec.d:
            raise ValueError(f"corpus dim {P.shape[1]} != spec d="
                             f"{self.spec.d}")
        db = self._owner.encrypt_database(
            P, M=self.spec.hnsw_M,
            ef_construction=self.spec.hnsw_ef_construction,
            progress_every=progress_every,
            build_index=self.spec.backend in ("hnsw", "graph"))
        return EncryptedCorpus(
            C_sap=db.C_sap, C_dce=db.C_dce,
            index=None if db.index is None else db.index.to_arrays())


# ---------------------------------------------------------------------------
# Querying user.
# ---------------------------------------------------------------------------

class QueryClient:
    """The trusted-user role: holds the shared keys, produces
    `EncryptedQuery` payloads (the only user-side work, O(d^2) per
    query, host numpy), and post-processes `SearchResult`s.

    seed=None (default) starts the query-randomness counter from fresh
    entropy: two clients sharing one key pair — or one client restarted
    — must never re-draw the same DCPE noise for different plaintext
    queries, or the server could difference the ciphertexts.  Pin a
    seed only for reproducible tests/benchmarks."""

    def __init__(self, keys: ppanns.Keys, seed: int | None = None):
        self.keys = keys
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2 ** 31))
        self._user = ppanns.User(keys, seed=seed)

    @classmethod
    def from_keystore(cls, keystore: Keystore | str | os.PathLike,
                      name: str, *, expect_d: int | None = None,
                      seed: int | None = None) -> "QueryClient":
        if not isinstance(keystore, Keystore):
            keystore = Keystore(keystore)
        return cls(keystore.load(name, expect_d=expect_d), seed=seed)

    def encrypt_query(self, q: np.ndarray) -> EncryptedQuery:
        """One plaintext query -> nq=1 EncryptedQuery."""
        c, t = self._user.encrypt_query(np.asarray(q))
        return EncryptedQuery(C_sap=c[None], T=t[None])

    def encrypt_queries(self, Q: np.ndarray) -> EncryptedQuery:
        """A batch of queries -> one batch-native EncryptedQuery."""
        pairs = [self._user.encrypt_query(q) for q in np.atleast_2d(Q)]
        return EncryptedQuery(C_sap=np.stack([c for c, _ in pairs]),
                              T=np.stack([t for _, t in pairs]))

    def request(self, tenant: str, collection: str, q: np.ndarray,
                params=None, **params_kw) -> SearchRequest:
        """Convenience: encrypt + wrap into a routed SearchRequest."""
        q = np.asarray(q)
        query = (self.encrypt_query(q) if q.ndim == 1
                 else self.encrypt_queries(q))
        if params is None:
            params = SearchParams(**params_kw)
        elif params_kw:
            params = dataclasses.replace(params, **params_kw)
        return SearchRequest(tenant=tenant, collection=collection,
                             query=query, params=params)

    @staticmethod
    def postprocess(result: SearchResult) -> list[np.ndarray]:
        """Per-query neighbor ids with the -1 padding stripped."""
        return result.ids_lists()


# ---------------------------------------------------------------------------
# The service.
# ---------------------------------------------------------------------------

class SecureAnnService:
    """The untrusted search server behind one typed surface.

    Collections created through this API are *keyless* — the service
    stores ciphertexts, filter state, and specs, never keys; plaintext
    ingestion is structurally impossible (the runtime raises).  The
    request scheduler (`IndexSpec.scheduler`: flush micro-batcher or
    continuous slot loop — DESIGN.md §12), tenant isolation, live
    ingestion, and telemetry of the serving runtime (DESIGN.md §8) all
    ride underneath unchanged.

    `device` is every collection's device: None means the card (and
    raises here without one), "cpu" runs the plain versions on the host.

    Observability (DESIGN.md §13): `obs=True` (or a pre-built
    `repro_torch.obs.Observability`) turns on per-request tracing and
    the cross-collection Prometheus metrics registry for every
    collection this service creates — exposed through `metrics_text()`,
    `export_chrome_trace()`, and `trace_events()`.  Default off: no
    recorder exists and the runtime records nothing.
    """

    def __init__(self, *, device=None, result_timeout: float = 120.0,
                 obs=None, **default_kw):
        if obs is True:
            obs = Observability(clock=default_kw.get("clock"))
        self.obs: Observability | None = obs
        if obs is not None:
            # every collection inherits the service-wide recorder and
            # registry unless the caller overrides per collection
            default_kw.setdefault("tracer", obs.recorder)
            default_kw.setdefault("metrics", obs.metrics)
        self._mgr = CollectionManager(device=device, **default_kw)
        self._specs: dict[tuple[str, str], IndexSpec] = {}
        self._placements: dict[tuple[str, str], PlacementSpec] = {}
        self._lock = threading.Lock()
        self.result_timeout = result_timeout

    # ------------------------------------------------------ collections

    def create_collection(self, spec: IndexSpec,
                          corpus: EncryptedCorpus | None = None, *,
                          placement: PlacementSpec | None = None
                          ) -> IndexSpec:
        """Create a (keyless) collection per the spec; optionally load an
        owner-uploaded `EncryptedCorpus` (ciphertexts + owner-built
        index) in the same call.  `placement` chooses the deployment
        (DESIGN.md §10): the single-device engine runs here; a sharded
        placement raises `NotImplementedError` until ROADMAP Queue 1
        item 6 (placement and sharding) is ported.  Returns the
        effective spec (seed resolved), which is what `save` persists
        (alongside the placement)."""
        if placement is None:
            placement = PlacementSpec()
        if placement.is_sharded:
            if spec.backend == "hnsw":
                raise ValueError(
                    "hnsw collections cannot be sharded: graph "
                    "traversal does not shard (DESIGN.md §3); use a "
                    "flat or ivf backend with sharded placement")
            raise NotImplementedError(
                "sharded placement is not ported yet (ROADMAP Queue 1 "
                "item 6: placement and sharding)")
        if corpus is not None:        # validate BEFORE creating: a bad
            if corpus.d != spec.d:    # corpus must not orphan an empty
                raise ValueError(     # collection under this name
                    f"corpus d={corpus.d} != spec d={spec.d}")
            if spec.backend in ("hnsw", "graph") and corpus.index is None:
                raise ValueError("hnsw/graph-backed collection needs an "
                                 "owner-built index in the corpus")
        col = self._mgr.create_collection(
            spec.tenant, spec.name, spec.d, keyless=True,
            placement=placement, **spec.collection_kwargs())
        if spec.seed is None:
            spec = dataclasses.replace(spec, seed=col.seed)
        with self._lock:
            self._specs[(spec.tenant, spec.name)] = spec
            self._placements[(spec.tenant, spec.name)] = placement
        if corpus is not None:
            col.load_snapshot(corpus.C_sap, corpus.C_dce,
                              graph_arrays=corpus.index)
        return spec

    def placement(self, tenant: str, name: str) -> PlacementSpec:
        self._mgr.collection(tenant, name)      # tenancy check first
        with self._lock:
            return self._placements[(tenant, name)]

    def drop_collection(self, tenant: str, name: str):
        self._mgr.drop_collection(tenant, name)
        with self._lock:
            self._specs.pop((tenant, name), None)
            self._placements.pop((tenant, name), None)

    def collection(self, tenant: str, name: str) -> Collection:
        """The underlying runtime collection — advanced/observability
        access (policy benches, telemetry); searches should go through
        `submit`."""
        return self._mgr.collection(tenant, name)

    # -------------------------------------------------------- ingestion

    def insert(self, tenant: str, name: str, C_sap: np.ndarray,
               C_dce: np.ndarray) -> np.ndarray:
        """Append owner-encrypted rows (the wire-format ingestion entry).
        Returns stable row ids; the rows are visible to the next search."""
        return self._mgr.collection(tenant, name).insert_encrypted(
            C_sap, C_dce)

    def delete(self, tenant: str, name: str, ids) -> int:
        return self._mgr.collection(tenant, name).delete(ids)

    def compact(self, tenant: str, name: str):
        self._mgr.collection(tenant, name).compact()

    def warmup(self, tenant: str, name: str, k: int = 10, **kw):
        self._mgr.collection(tenant, name).warmup(k, **kw)

    def stats(self, tenant: str, name: str) -> dict:
        return self._mgr.collection(tenant, name).stats()

    # ----------------------------------------------------------- search

    def submit(self, req: SearchRequest) -> SearchResult:
        """The one search entry.  Single-query requests with
        coalesce=True ride the collection's scheduler (concurrent
        submitters share engine calls); batch requests and coalesce=False
        go straight to one locked engine call.

        Under a padding security profile (DESIGN.md §14) the returned id
        matrix is widened to the profile's fixed result width with -1
        columns, so the response size leaks the width class, not k; the
        real ids and their order are bit-identical to the "perf" tier,
        and `SearchResult.ids_lists()` strips the padding client-side."""
        col = self._mgr.collection(req.tenant, req.collection)
        p = req.params
        if req.coalesce and req.query.nq == 1 and p.refine == "tournament":
            fut = col.submit(req.query.C_sap[0], req.query.T[0], p.k,
                             ratio_k=p.ratio_k, ef_search=p.ef_search,
                             want_stats=True, trace_id=req.trace_id)
            ids_row, stats = fut.result(timeout=self.result_timeout)
            ids = ids_row[None]
        else:
            ids, stats = col.search_batch(
                req.query.C_sap, req.query.T, p.k, ratio_k=p.ratio_k,
                ef_search=p.ef_search, refine=p.refine)
        ids = self._pad_result(req, col, np.asarray(ids, np.int64), p.k)
        return SearchResult(ids=ids, stats=stats)

    def _pad_result(self, req: SearchRequest, col: Collection,
                    ids: np.ndarray, k: int) -> np.ndarray:
        """Widen the id matrix to the collection profile's fixed result
        width (-1 padding).  The padding bytes feed the telemetry's
        `ann_padded_bytes_total`; the engine-side `bytes_down` keeps
        counting the unpadded payload (the two counters separate the
        scheme's communication model from the profile's overhead)."""
        with self._lock:
            spec = self._specs.get((req.tenant, req.collection))
        profile = (get_profile(spec.security_profile)
                   if spec is not None else DEFAULT_PROFILE)
        width = profile.result_width(k)
        if width <= ids.shape[1]:
            return ids
        pad = np.full((ids.shape[0], width - ids.shape[1]), -1, np.int64)
        col.telemetry.record_padded_bytes(pad.size * pad.itemsize)
        return np.concatenate([ids, pad], axis=1)

    # ------------------------------------------------------ persistence

    @staticmethod
    def _collection_filename(tenant: str, name: str) -> str:
        quote = lambda s: urllib.parse.quote(s, safe="")     # noqa: E731
        return f"{quote(tenant)}__{quote(name)}{_COLLECTION_SUFFIX}"

    def save(self, root: str | os.PathLike) -> list[pathlib.Path]:
        """Persist every collection to `<root>/<tenant>__<name>.ppcol`.

        Each file is a versioned wire payload holding the ciphertext
        store (with tombstone encoding), the main/delta bookkeeping, the
        hnsw/graph filter graph, IVF index or ADC codebook when there is
        one, and the effective spec — the JAX package's frame, so either
        package loads it.  No key material exists anywhere in the
        service, so none can leak into the snapshot."""
        root = pathlib.Path(root)
        root.mkdir(parents=True, exist_ok=True)
        with self._lock:
            specs = dict(self._specs)
            placements = dict(self._placements)
        paths = []
        for (tenant, name), spec in sorted(specs.items()):
            arrays, bookkeeping = self._mgr.collection(tenant,
                                                       name).snapshot()
            meta = {"spec": spec.to_dict(),
                    "placement": placements[(tenant, name)].to_dict(),
                    **bookkeeping}
            path = root / self._collection_filename(tenant, name)
            tmp = path.with_suffix(_COLLECTION_SUFFIX + ".tmp")
            tmp.write_bytes(pack("encrypted-collection", PROTOCOL_VERSION,
                                 arrays=arrays, meta=meta))
            os.replace(tmp, path)
            paths.append(path)
        return paths

    @classmethod
    def load(cls, root: str | os.PathLike, *, device=None,
             result_timeout: float = 120.0,
             **default_kw) -> "SecureAnnService":
        """Rebuild a service from `save` output (this package's or the
        JAX package's) in a fresh process.  A reloaded collection answers
        searches bit-identically: the store (ids, tombstones, main/delta
        split), the filter graph, the IVF index, the ADC codebook and
        the seed-keyed flat state all come back exactly."""
        root = pathlib.Path(root)
        svc = cls(device=device, result_timeout=result_timeout,
                  **default_kw)
        files = sorted(root.glob(f"*{_COLLECTION_SUFFIX}"))
        if not files:
            raise FileNotFoundError(f"no {_COLLECTION_SUFFIX} files "
                                    f"under {root}")
        for f in files:
            arrays, meta = unpack(f.read_bytes(), "encrypted-collection",
                                  PROTOCOL_VERSION)
            spec = IndexSpec.from_dict(meta["spec"])
            # pre-placement snapshots carry no placement key -> single
            placement = (PlacementSpec.from_dict(meta["placement"])
                         if meta.get("placement") else None)
            svc.create_collection(spec, placement=placement)
            graph_arrays = {k[len("graph__"):]: v for k, v in arrays.items()
                            if k.startswith("graph__")} or None
            ivf_state = None
            if "ivf__centroids" in arrays:
                ivf_state = {
                    "centroids": arrays["ivf__centroids"],
                    "list_flat": arrays["ivf__list_flat"],
                    "list_offsets": arrays["ivf__list_offsets"],
                    "built_upto": meta["ivf_built_upto"],
                    "attached_gen": meta["ivf_attached_gen"],
                }
            adc_arrays = {k[len("adc__"):]: v for k, v in arrays.items()
                          if k.startswith("adc__")}
            adc_state = ({"arrays": adc_arrays,
                          "trained_gen": meta["adc_trained_gen"]}
                         if adc_arrays else None)
            svc._mgr.collection(spec.tenant, spec.name).load_snapshot(
                arrays["C_sap"], arrays["C_dce"], alive=arrays["alive"],
                n_main=int(meta["n_main"]), main_gen=int(meta["main_gen"]),
                graph_arrays=graph_arrays, ivf_state=ivf_state,
                adc_state=adc_state)
        return svc

    # ---------------------------------------------------- observability

    def metrics_text(self) -> str:
        """Prometheus text exposition of the service-wide registry
        (DESIGN.md §13).  With observability off, a parseable
        comment-only document — a scrape target that is wired up but
        dark, rather than an error."""
        if self.obs is None:
            return ("# observability disabled "
                    "(construct SecureAnnService with obs=True)\n")
        return self.obs.metrics_text()

    def trace_events(self) -> list[dict]:
        """The recorder's structured event log ([] with obs off)."""
        return [] if self.obs is None else self.obs.events()

    def export_chrome_trace(self, path: str | os.PathLike) -> str:
        """Write the recorded spans as Chrome-trace/Perfetto JSON."""
        if self.obs is None:
            raise RuntimeError("observability is off: construct "
                               "SecureAnnService with obs=True")
        return self.obs.export_chrome_trace(path)

    # ------------------------------------------------------------- misc

    def close(self):
        self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
