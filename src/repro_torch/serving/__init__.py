"""Serving layer: the batched secure-search engine and its filters, its
row-sharded deployment, the serving runtime, and the LM server — the
names of `repro.serving`.

Exports resolve lazily so that light-weight users (e.g. core.ppanns
importing the search engine) do not pull in the LM model stack.
"""

import importlib

_EXPORTS = {
    "LMServer": ".engine",
    "DistributedSecureANN": ".ann_server",
    "ShardedBackend": ".sharded",
    "SecureSearchEngine": ".search_engine",
    "SearchStats": ".search_engine",
    "FlatScanFilter": ".search_engine",
    "IVFScanFilter": ".search_engine",
    "HNSWGraphFilter": ".search_engine",
    "CollectionManager": ".runtime",
    "Collection": ".runtime",
    "MicroBatcher": ".runtime",
    "QueueFullError": ".runtime",
    "TenantIsolationError": ".runtime",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(_EXPORTS[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
