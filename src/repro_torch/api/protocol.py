"""Typed, wire-serializable protocol objects (DESIGN.md §9), the
counterpart of `repro.api.protocol`: the same types, validation and
frames, so a payload written by either package is read by the other
and the same content gives the same bytes.

These dataclasses are the *entire* vocabulary of the client/service
protocol — what a data owner, a querying user, and the untrusted search
service exchange:

  IndexSpec        owner -> service   what collection to create
  EncryptedCorpus  owner -> service   ciphertexts (+ owner-built index)
  EncryptedQuery   user  -> service   DCPE query ciphertexts + trapdoors
  SearchRequest    user  -> service   routed query + SearchParams
  SearchResult     service -> user    ids + the engine's SearchStats

Every type round-trips through versioned `to_bytes`/`from_bytes`
(npz-backed, see `core.wireformat`), so each leg of the protocol can
cross a process or wire boundary.  Arrays are bit-exact across a round
trip; a mismatched kind or version raises `WireFormatError` instead of
misparsing.

Ciphertext conventions (paper §IV/§V): for dimension d the DCPE
ciphertext keeps shape (d,) and the DCE trapdoor has 2*(d + d%2) + 16
components; `EncryptedQuery` is batch-native — a single query is the
nq=1 case, so the client/service protocol has one shape story, not two.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import dce
from ..core.dcpe import suggest_beta                      # noqa: F401
from ..core.ppanns import Keys                            # noqa: F401
from ..core.wireformat import WireFormatError, pack, unpack
from ..serving.search_engine import SearchStats

__all__ = ["PROTOCOL_VERSION", "WireFormatError", "IndexSpec",
           "PlacementSpec", "SearchParams", "EncryptedQuery",
           "EncryptedCorpus", "SearchRequest", "SearchResult",
           "SearchStats", "Keys", "suggest_beta"]

PROTOCOL_VERSION = 1

_BACKENDS = ("flat", "ivf", "hnsw", "graph")
_PLACEMENT_KINDS = ("single", "sharded")
_QUANTIZATIONS = (None, "int8", "pq8")
_SCHEDULERS = ("flush", "continuous")
_SECURITY_PROFILES = ("perf", "balanced", "hardened", "oblivious-sketch")
_OBLIVIOUS_PROFILES = ("hardened", "oblivious-sketch")


# ---------------------------------------------------------------------------
# PlacementSpec — WHERE a collection executes (deployment as a parameter).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """Deployment placement of one collection (DESIGN.md §10).

    `single` runs the engine's single-device path; `sharded` row-shards
    the ciphertexts across `n_shards` mesh devices on axis `data_axis`
    and runs the shard_map filter + sharded refine gather.  Placement is
    a *parameter* of `SecureAnnService.create_collection` — the same
    `submit(SearchRequest)` surface, micro-batcher, tenancy, ingestion,
    and persistence work over either.

    `n_shards=None` (sharded) means "every local device"; the service
    pins the effective count at creation (`resolve`), which is what
    `save` persists — a reloaded collection re-shards identically.
    In this package a sharded placement validates and round-trips on
    the wire, but no collection runs it yet (ROADMAP Queue 1 item 6).

    `n_replicas` (DESIGN.md §16) is the availability knob: each shard
    group keeps that many logical replicas registered with the backend's
    health registry, and searches route around dead replicas — a shard
    answers while >= 1 of its replicas lives; only a fully-dead group
    degrades the answer (`SearchResult.degraded`).  Wire-versioned
    additively: payloads from before the field default to 1.
    """
    kind: str = "single"
    data_axis: str = "data"
    n_shards: int | None = None
    n_replicas: int = 1

    def __post_init__(self):
        self.validate()

    def validate(self):
        if self.kind not in _PLACEMENT_KINDS:
            raise ValueError(f"unknown placement kind {self.kind!r} "
                             f"(have {_PLACEMENT_KINDS})")
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got "
                             f"{self.n_replicas}")
        if self.kind == "single":
            if self.n_shards not in (None, 1):
                raise ValueError("single placement cannot set n_shards "
                                 f"(got {self.n_shards})")
            if self.n_replicas != 1:
                raise ValueError("single placement cannot set n_replicas "
                                 f"(got {self.n_replicas}) — replication "
                                 "is a sharded-placement knob")
        else:
            if not self.data_axis:
                raise ValueError("sharded placement needs a non-empty "
                                 "data_axis name")
            if self.n_shards is not None and self.n_shards < 1:
                raise ValueError(f"n_shards must be >= 1, got "
                                 f"{self.n_shards}")

    @property
    def is_sharded(self) -> bool:
        return self.kind == "sharded"

    def resolve(self, n_devices: int) -> "PlacementSpec":
        """Pin `n_shards=None` to the device count at creation time."""
        if not self.is_sharded:
            return self
        n = int(self.n_shards or n_devices)
        if n > n_devices:
            raise ValueError(f"placement wants {n} shards but only "
                             f"{n_devices} device(s) exist")
        return dataclasses.replace(self, n_shards=n)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PlacementSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise WireFormatError(
                f"PlacementSpec: unknown fields {sorted(extra)}")
        return cls(**d)

    def to_bytes(self) -> bytes:
        return pack("placement-spec", PROTOCOL_VERSION, arrays={},
                    meta=self.to_dict())

    @classmethod
    def from_bytes(cls, data: bytes) -> "PlacementSpec":
        _, meta = unpack(data, "placement-spec", PROTOCOL_VERSION)
        try:
            return cls.from_dict(meta)
        except (TypeError, ValueError) as e:
            raise WireFormatError(f"bad placement-spec payload: {e}") from e


# ---------------------------------------------------------------------------
# IndexSpec — the one config object behind every entry point.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IndexSpec:
    """Everything needed to create (or re-create) a collection.

    Identity (`tenant`, `name`) routes requests; `d` fixes the
    ciphertext shapes; `backend` picks the filter index the service
    builds; the crypto fields parameterize the owner's keygen; the
    batching fields tune the service's micro-batcher.  `seed` keys both
    the owner's keygen and the service's deterministic index state —
    `None` means fresh entropy (the service records the effective seed
    when persisting, so a reloaded collection rebuilds identically).

    `scheduler` picks how the service shares engine calls between
    concurrent requests (DESIGN.md §12): "flush" is the deadline/size
    micro-batcher over bucketed shapes; "continuous" is the
    slot-table serving loop — no deadline, one compiled shape,
    better open-loop p99.  Wire-versioned additively: payloads from
    before the field default to "flush".

    `use_kernel` stays a wire field only, so that specs and `.ppcol`
    files saved by the JAX package load here; nothing reads it and
    `collection_kwargs` does not pass it on.  A collection's device
    decides: on the card every kernel of its path is the hand-written
    one, and `use_kernel=False` never switches them off.

    `quantization` compresses the *filter* ciphertexts server-side
    (DESIGN.md §11): None scans f32 DCPE ciphertexts; "int8"/"pq8"
    scan 1-byte/dim scalar-quantized or m-byte/vector product-
    quantized codes through the fused adc_topk path, oversampling
    k' by `refine_ratio` (None = the per-kind default, core.adc)
    into the unchanged exact DCE refine.  flat/ivf/graph backends
    (the batched graph traversal scores edges with the same ADC
    surrogates, DESIGN.md §15).

    `security_profile` picks the leakage tier (`sec`, DESIGN.md
    §14): "perf" serves the engine unflattened; "balanced" adds
    dummy-query batch padding + fixed-shape results; "hardened" /
    "oblivious-sketch" additionally pad every flush to `max_batch` and
    run scan-oblivious full-bucket filters (flat/ivf, plus the graph
    backend's bounded-hop fixed-fanout traversal).  Returned real ids
    are identical under every profile.
    """
    tenant: str
    name: str
    d: int
    backend: str = "flat"
    # crypto (owner-side)
    sap_beta: float = 1.0
    sap_s: float = 1024.0
    seed: int | None = None
    # filter index (service-side)
    n_partitions: int = 64
    nprobe: int = 8
    hnsw_M: int = 16
    hnsw_ef_construction: int = 200
    use_kernel: bool = True
    # quantized ADC filter (service-side, keyless — DESIGN.md §11)
    quantization: str | None = None
    refine_ratio: float | None = None
    pq_m: int = 16
    # request scheduler / runtime
    scheduler: str = "flush"
    max_batch: int = 32
    max_wait_ms: float = 2.0          # flush scheduler only
    max_queue: int = 256
    compact_every: int = 4096
    # leakage tier (sec, DESIGN.md §14).  Wire-versioned
    # additively: payloads from before the field default to "perf".
    security_profile: str = "perf"

    def __post_init__(self):
        self.validate()

    def validate(self):
        if not self.tenant or not self.name:
            raise ValueError("IndexSpec needs non-empty tenant and name")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(have {_BACKENDS})")
        if self.d < 2:
            raise ValueError("PP-ANNS requires d >= 2")
        if self.quantization not in _QUANTIZATIONS:
            raise ValueError(f"unknown quantization {self.quantization!r} "
                             f"(have {_QUANTIZATIONS})")
        if self.quantization is not None and self.backend == "hnsw":
            raise ValueError("quantization applies to flat|ivf|graph "
                             "backends (the per-query host walk reads "
                             "full-precision rows)")
        if self.refine_ratio is not None:
            if self.quantization is None:
                raise ValueError("refine_ratio is the ADC oversampling "
                                 "factor — it needs quantization set")
            if self.refine_ratio < 1.0:
                raise ValueError(f"refine_ratio must be >= 1, got "
                                 f"{self.refine_ratio}")
        if self.pq_m < 1:
            raise ValueError(f"pq_m must be >= 1, got {self.pq_m}")
        if self.scheduler not in _SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r} "
                             f"(have {_SCHEDULERS})")
        if self.security_profile not in _SECURITY_PROFILES:
            raise ValueError(
                f"unknown security_profile {self.security_profile!r} "
                f"(have {_SECURITY_PROFILES})")
        if (self.security_profile in _OBLIVIOUS_PROFILES
                and self.backend == "hnsw"):
            raise ValueError(
                f"security_profile {self.security_profile!r} needs the "
                f"scan-oblivious filter variant, and the per-query host "
                f"walk is data-dependent by construction — use flat|ivf "
                f"backends, or backend='graph' for the bounded-hop "
                f"fixed-fanout traversal tier (DESIGN.md §14/§15)")

    @property
    def cdim(self) -> int:
        """DCE trapdoor / ciphertext component dimension for this d."""
        return dce.ciphertext_dim(self.d)

    def collection_kwargs(self) -> dict:
        """Constructor kwargs for the runtime `Collection` (without
        `use_kernel`: the collection's device decides, see above)."""
        return dict(
            backend=self.backend, sap_beta=self.sap_beta,
            sap_s=self.sap_s, seed=self.seed, scheduler=self.scheduler,
            max_batch=self.max_batch, max_wait_ms=self.max_wait_ms,
            max_queue=self.max_queue, compact_every=self.compact_every,
            n_partitions=self.n_partitions, nprobe=self.nprobe,
            hnsw_M=self.hnsw_M,
            hnsw_ef_construction=self.hnsw_ef_construction,
            quantization=self.quantization,
            refine_ratio=self.refine_ratio, pq_m=self.pq_m,
            security_profile=self.security_profile)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "IndexSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise WireFormatError(f"IndexSpec: unknown fields {sorted(extra)}")
        return cls(**d)

    def to_bytes(self) -> bytes:
        return pack("index-spec", PROTOCOL_VERSION, arrays={},
                    meta=self.to_dict())

    @classmethod
    def from_bytes(cls, data: bytes) -> "IndexSpec":
        _, meta = unpack(data, "index-spec", PROTOCOL_VERSION)
        return cls.from_dict(meta)


# ---------------------------------------------------------------------------
# SearchParams — the per-request knobs of Algorithm 2.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchParams:
    """k plus the filter/refine knobs (paper Algorithm 2).  Requests
    micro-batch together only when their (k, ratio_k, ef_search) agree —
    one engine call serves one setting of them."""
    k: int = 10
    ratio_k: float = 8.0
    ef_search: int = 96
    refine: str = "tournament"      # | "none" (filter-only, Fig. 6)

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.refine not in ("tournament", "none"):
            raise ValueError(f"batched refine must be 'tournament' or "
                             f"'none', got {self.refine!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SearchParams":
        return cls(**d)

    def to_bytes(self) -> bytes:
        return pack("search-params", PROTOCOL_VERSION, arrays={},
                    meta=self.to_dict())

    @classmethod
    def from_bytes(cls, data: bytes) -> "SearchParams":
        _, meta = unpack(data, "search-params", PROTOCOL_VERSION)
        return cls.from_dict(meta)


# ---------------------------------------------------------------------------
# EncryptedQuery — what the user sends (batch-native).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EncryptedQuery:
    """(nq, d) DCPE query ciphertexts + (nq, 2d+16) DCE trapdoors.

    This is all the server ever learns about a query (paper §V-C): the
    user-side O(d^2) encryption happens in `QueryClient.encrypt_query`.
    """
    C_sap: np.ndarray
    T: np.ndarray

    def __post_init__(self):
        self.C_sap = np.atleast_2d(np.asarray(self.C_sap, np.float32))
        self.T = np.atleast_2d(np.asarray(self.T, np.float32))
        if self.C_sap.shape[0] != self.T.shape[0]:
            raise ValueError(
                f"{self.C_sap.shape[0]} ciphertexts vs "
                f"{self.T.shape[0]} trapdoors")
        if self.T.shape[1] != dce.ciphertext_dim(self.C_sap.shape[1]):
            raise ValueError(
                f"trapdoor dim {self.T.shape[1]} does not match "
                f"d={self.C_sap.shape[1]} "
                f"(expect {dce.ciphertext_dim(self.C_sap.shape[1])})")

    @property
    def nq(self) -> int:
        return self.C_sap.shape[0]

    @property
    def d(self) -> int:
        return self.C_sap.shape[1]

    @property
    def nbytes(self) -> int:
        return self.C_sap.nbytes + self.T.nbytes

    def to_bytes(self) -> bytes:
        return pack("encrypted-query", PROTOCOL_VERSION,
                    arrays={"C_sap": self.C_sap, "T": self.T})

    @classmethod
    def from_bytes(cls, data: bytes) -> "EncryptedQuery":
        arrays, _ = unpack(data, "encrypted-query", PROTOCOL_VERSION)
        try:
            return cls(C_sap=arrays["C_sap"], T=arrays["T"])
        except (KeyError, ValueError) as e:
            raise WireFormatError(f"bad encrypted-query payload: {e}") from e


# ---------------------------------------------------------------------------
# EncryptedCorpus — what the owner uploads (ciphertexts + optional index).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EncryptedCorpus:
    """The owner's outsourced database (paper §V-A): DCPE filter
    ciphertexts, DCE refine ciphertexts, and — for hnsw collections —
    the owner-built filter graph (`HNSW.to_arrays` payload, a function
    of ciphertexts only).  The service stores this and nothing else."""
    C_sap: np.ndarray               # (n, d)
    C_dce: np.ndarray               # (n, 4, 2d+16)
    index: dict | None = None       # HNSW.to_arrays() arrays, or None

    def __post_init__(self):
        self.C_sap = np.atleast_2d(np.asarray(self.C_sap, np.float32))
        self.C_dce = np.asarray(self.C_dce, np.float32)
        n, d = self.C_sap.shape
        if self.C_dce.shape != (n, 4, dce.ciphertext_dim(d)):
            raise ValueError(
                f"C_dce shape {self.C_dce.shape} does not match n={n}, "
                f"d={d} (expect {(n, 4, dce.ciphertext_dim(d))})")

    @property
    def n(self) -> int:
        return self.C_sap.shape[0]

    @property
    def d(self) -> int:
        return self.C_sap.shape[1]

    def to_bytes(self) -> bytes:
        arrays = {"C_sap": self.C_sap, "C_dce": self.C_dce}
        if self.index is not None:
            arrays.update({f"index__{k}": v for k, v in self.index.items()})
        return pack("encrypted-corpus", PROTOCOL_VERSION, arrays=arrays,
                    meta={"has_index": self.index is not None})

    @classmethod
    def from_bytes(cls, data: bytes) -> "EncryptedCorpus":
        arrays, meta = unpack(data, "encrypted-corpus", PROTOCOL_VERSION)
        index = None
        if meta.get("has_index"):
            index = {k[len("index__"):]: v for k, v in arrays.items()
                     if k.startswith("index__")}
        try:
            return cls(C_sap=arrays["C_sap"], C_dce=arrays["C_dce"],
                       index=index)
        except (KeyError, ValueError) as e:
            raise WireFormatError(f"bad encrypted-corpus payload: {e}") from e


# ---------------------------------------------------------------------------
# SearchRequest / SearchResult — the submit() round trip.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchRequest:
    """One routed search: (tenant, collection) + query + params.

    coalesce=True lets a single-query request ride the service's
    micro-batcher (throughput under concurrency); batch requests and
    coalesce=False go straight to one locked engine call.

    trace_id (optional) names the request's trace when the service runs
    with observability on (DESIGN.md §13) — a client-propagated
    correlation id, carried additively on the wire (old payloads decode
    with trace_id=None, same pattern as coalesce).  It never influences
    the search result.
    """
    tenant: str
    collection: str
    query: EncryptedQuery
    params: SearchParams = dataclasses.field(default_factory=SearchParams)
    coalesce: bool = True
    trace_id: str | None = None

    def to_bytes(self) -> bytes:
        meta = {"tenant": self.tenant,
                "collection": self.collection,
                "params": self.params.to_dict(),
                "coalesce": bool(self.coalesce)}
        if self.trace_id is not None:
            meta["trace_id"] = str(self.trace_id)
        return pack("search-request", PROTOCOL_VERSION,
                    arrays={"C_sap": self.query.C_sap, "T": self.query.T},
                    meta=meta)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SearchRequest":
        arrays, meta = unpack(data, "search-request", PROTOCOL_VERSION)
        try:
            return cls(tenant=meta["tenant"], collection=meta["collection"],
                       query=EncryptedQuery(C_sap=arrays["C_sap"],
                                            T=arrays["T"]),
                       params=SearchParams.from_dict(meta["params"]),
                       coalesce=bool(meta.get("coalesce", True)),
                       trace_id=meta.get("trace_id"))
        except (KeyError, TypeError, ValueError) as e:
            raise WireFormatError(f"bad search-request payload: {e}") from e


@dataclasses.dataclass
class SearchResult:
    """(nq, k) int64 neighbor ids (-1 fills slots where a query had
    fewer than k real candidates) + the engine's uniform SearchStats.

    For a coalesced single-query request the stats describe the flush
    the request rode in (stats.n_queries = how many requests shared the
    batched engine call).

    `degraded` (DESIGN.md §16) surfaces failover: True means some shard
    group had no live replica when this answer was computed, so the ids
    cover only the alive shards' rows — a labelled partial answer
    instead of a failed request.  Carried additively inside the stats
    payload (`SearchStats.degraded` / `n_shards_down` default to
    healthy), so pre-resilience peers interoperate."""
    ids: np.ndarray
    stats: SearchStats

    @property
    def degraded(self) -> bool:
        return bool(self.stats.degraded)

    def __post_init__(self):
        self.ids = np.atleast_2d(np.asarray(self.ids, np.int64))

    @property
    def nq(self) -> int:
        return self.ids.shape[0]

    @property
    def k(self) -> int:
        return self.ids.shape[1]

    def ids_lists(self) -> list[np.ndarray]:
        """Per-query ids with the -1 padding stripped — the user-side
        post-processing step."""
        return [row[row >= 0] for row in self.ids]

    def to_bytes(self) -> bytes:
        return pack("search-result", PROTOCOL_VERSION,
                    arrays={"ids": self.ids},
                    meta={"stats": dataclasses.asdict(self.stats)})

    @classmethod
    def from_bytes(cls, data: bytes) -> "SearchResult":
        arrays, meta = unpack(data, "search-result", PROTOCOL_VERSION)
        try:
            return cls(ids=arrays["ids"],
                       stats=SearchStats(**meta["stats"]))
        except (KeyError, TypeError) as e:
            raise WireFormatError(f"bad search-result payload: {e}") from e
