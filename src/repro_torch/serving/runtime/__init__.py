"""Online serving runtime over the unified secure-search engine
(DESIGN.md §8, §12), the counterpart of `repro.serving.runtime`.

  batcher      `Scheduler` interface (queue, admission control, futures,
               injected clock) + the flush-based `MicroBatcher`:
               bucketed padded batches, deadline/size flush
  slot_loop    `SlotLoop`: continuous batching over one fixed slot
               table — insert into free slots, emit on completion, no
               deadline, one shape (DESIGN.md §12)
  clock        deterministic time seam: `SystemClock` (production) /
               `VirtualClock` (tests drive scheduler time manually)
  collections  multi-tenant `CollectionManager`: per-tenant keys,
               ciphertext stores, index, engine; strict routing;
               per-collection scheduler selection; `device=` (None: the
               card, "cpu": the plain versions)
  ingest       live encrypted ingestion: mutable tombstoned store,
               delta buffer + compaction, delta-aware filter backend
               whose device tensors are written in place
  telemetry    per-collection QPS / batch + slot occupancy / p50-p99
               sojourn / queue depth, kernel-library build tracking
"""

from .batcher import MicroBatcher, QueueFullError, Scheduler, batch_buckets
from .clock import Clock, SystemClock, VirtualClock
from .collections import (SCHEDULERS, Collection, CollectionManager,
                          TenantIsolationError)
from .ingest import DeltaAwareBackend, MutableEncryptedStore
from .slot_loop import SlotLoop
from .telemetry import CollectionTelemetry, jit_cache_size

__all__ = [
    "Scheduler", "MicroBatcher", "SlotLoop", "QueueFullError",
    "batch_buckets", "SCHEDULERS",
    "Clock", "SystemClock", "VirtualClock",
    "Collection", "CollectionManager", "TenantIsolationError",
    "DeltaAwareBackend", "MutableEncryptedStore",
    "CollectionTelemetry", "jit_cache_size",
]
