"""Serving layer: the batched secure-search engine."""

from .search_engine import (FlatScanFilter, SearchStats,  # noqa: F401
                            SecureSearchEngine, refine_candidates)
