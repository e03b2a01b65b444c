"""Serving layer: the batched secure-search engine."""

from .search_engine import (FlatScanFilter, HNSWGraphFilter,  # noqa: F401
                            SearchStats, SecureSearchEngine,
                            refine_candidates)
