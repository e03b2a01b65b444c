"""Serving layer: the batched secure-search engine and its filters."""

from .search_engine import (ADCFilter, FlatScanFilter,  # noqa: F401
                            HNSWGraphFilter, IVFScanFilter, SearchStats,
                            SecureSearchEngine, layout_pools,
                            refine_candidates)
