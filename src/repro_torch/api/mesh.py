"""DEPRECATED sharded-service wrapper (DESIGN.md §10) + secure-scan step
re-exports, the counterpart of `repro.api.mesh`.

`DistributedSecureAnnService` predates placement-aware collections: it
was a second, weaker service class (exhaustive flat scan only, a
`search(query, params)` surface instead of `submit(SearchRequest)`, no
batching/tenancy/ingestion/persistence).  Deployment is now a parameter
of the one public API:

    svc.create_collection(spec, corpus=corpus,
                          placement=PlacementSpec(kind="sharded"))

This module keeps the old class as a thin `DeprecationWarning` shim over
exactly that path, and keeps re-exporting the secure-scan step builders
(`serving.secure_scan`) so launch tooling still reaches them through the
public surface.  Where the JAX package's shim takes a mesh, this one
takes the placement devices (`launch.mesh.local_devices`).
"""

from __future__ import annotations

import warnings

import numpy as np

from ..serving.secure_scan import (build_secure_scan_step,          # noqa: F401
                                   build_secure_scan_step_gspmd,    # noqa: F401
                                   secure_scan_input_specs,         # noqa: F401
                                   secure_scan_pspecs)              # noqa: F401
from .protocol import (EncryptedCorpus, EncryptedQuery, IndexSpec,
                       PlacementSpec, SearchParams, SearchRequest,
                       SearchResult)
from .roles import SecureAnnService

__all__ = ["DistributedSecureAnnService", "build_secure_scan_step",
           "build_secure_scan_step_gspmd", "secure_scan_input_specs",
           "secure_scan_pspecs"]

_TENANT, _NAME = "_legacy", "mesh"


class DistributedSecureAnnService:
    """DEPRECATED: a sharded collection behind the unified service.

    Construct `SecureAnnService` and pass
    `placement=PlacementSpec(kind="sharded", ...)` to
    `create_collection` instead — that path adds batching, tenancy,
    live ingestion, and persistence on top of the same sharded
    execution.  This shim routes `search` through it unchanged.
    `devices`: the placement devices to shard over (None: one shard);
    `device`: the collection's device (None: the card, "cpu": the
    host)."""

    def __init__(self, corpus, C_dce=None, *, devices=None,
                 axis: str = "data", device=None):
        warnings.warn(
            "DistributedSecureAnnService is deprecated; create a "
            "sharded collection through repro_torch.api instead: "
            "SecureAnnService.create_collection(spec, corpus=corpus, "
            "placement=PlacementSpec(kind='sharded', ...)) — same ids, "
            "one service surface", DeprecationWarning, stacklevel=2)
        if not isinstance(corpus, EncryptedCorpus):
            if C_dce is None:
                raise ValueError("pass an EncryptedCorpus or both "
                                 "(C_sap, C_dce) arrays")
            corpus = EncryptedCorpus(C_sap=np.asarray(corpus),
                                     C_dce=np.asarray(C_dce))
        n_shards = 1 if devices is None else len(devices)
        # sap_beta/sap_s never matter here: the collection is keyless
        # and ingests the given ciphertexts as-is
        spec = IndexSpec(tenant=_TENANT, name=_NAME, d=corpus.d,
                         backend="flat", seed=0)
        self._svc = SecureAnnService(device=device)
        self._svc.create_collection(
            spec, corpus=corpus,
            placement=PlacementSpec(kind="sharded", data_axis=axis,
                                    n_shards=n_shards))
        self._n = corpus.n

    @property
    def n(self) -> int:
        return self._n

    def search(self, query: EncryptedQuery,
               params: SearchParams = SearchParams()) -> SearchResult:
        return self._svc.submit(SearchRequest(
            tenant=_TENANT, collection=_NAME, query=query, params=params,
            coalesce=False))

    def close(self):
        self._svc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
