"""repro_torch.resilience — fault-tolerant serving substrate (DESIGN.md
§16), the counterpart of `repro.resilience`.

Three layers, one contract ("acked means recoverable, unhealthy means
answered and labelled"):

  * durability — `WriteAheadLog` (ciphertext-only, fsync'd, segment-
    rotated), `AsyncCheckpointer` (background `.ppcol` checkpoints that
    never block serving), `recover` (checkpoint + replay -> bit-
    identical acknowledged state after a kill at any point);
  * availability — `ShardHealthRegistry` (replica up/down + epoch) the
    sharded backend routes around: one dead replica is invisible, a
    fully-dead shard group degrades the answer (`SearchResult.degraded`,
    `SearchStats.n_shards_down`) instead of failing it, and the
    schedulers retry transient engine faults per-request
    (`EngineRetryPolicy`) with poison-query quarantine;
  * determinism — `FaultPlan` injects kills, crashes around fsync,
    engine exceptions, and straggler delays at exact logical points on
    the `VirtualClock` seam, so every failure interleaving in the test
    suite replays exactly.

The step runner lives here (`RetryPolicy`, `ResilientRunner`,
`StragglerWatchdog`), on the injected `Clock`; `repro_torch.ft` is a
deprecation shim.

All of it is host code (numpy, threads, files) copied from the JAX
package; only `ShardHealthRegistry` reaches the card, through the
sharded backend that routes around dead shard groups.
"""

from ..serving.runtime.batcher import EngineRetryPolicy  # noqa: F401
from .checkpoint import (AsyncCheckpointer,              # noqa: F401
                         collection_state_bytes,
                         restore_collection_state)
from .faults import FaultPlan, InjectedFault, SimulatedCrash  # noqa: F401
from .health import ShardHealthRegistry                  # noqa: F401
from .recovery import RecoveryReport, attach_wal, recover  # noqa: F401
from .runner import (ResilientRunner, RetryPolicy,       # noqa: F401
                     StragglerWatchdog, sleep_on)
from .wal import WalCorruptionError, WalRecord, WriteAheadLog  # noqa: F401

__all__ = [
    "WriteAheadLog", "WalRecord", "WalCorruptionError",
    "AsyncCheckpointer", "collection_state_bytes",
    "restore_collection_state",
    "recover", "RecoveryReport", "attach_wal",
    "ShardHealthRegistry",
    "FaultPlan", "InjectedFault", "SimulatedCrash",
    "EngineRetryPolicy",
    "RetryPolicy", "ResilientRunner", "StragglerWatchdog", "sleep_on",
]
