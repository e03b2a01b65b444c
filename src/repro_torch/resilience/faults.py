"""Deterministic fault injection for the serving runtime (DESIGN.md §16),
the counterpart of `repro.resilience.faults` (host code, copied).

A `FaultPlan` is a declarative schedule of faults keyed on *logical*
event counts — the Nth batched engine call, the Nth WAL append — not on
wall time, so a seeded test replays the exact same failure interleaving
on every run.  It drives three seams the runtime already exposes:

  * the scheduler's `run_batch` callable (engine exceptions at step N,
    shard kill/revive through the backend's health registry, straggler
    delays via `VirtualClock.advance` — the injected-clock seam from
    DESIGN.md §12);
  * the WAL's `fault_hook` (crash-before-fsync = a torn half-written
    record that recovery must drop, crash-after-fsync = a record durable
    on disk whose ack never reached the client);
  * nothing else — faults enter through public seams only, so what the
    tests prove is the production code path, not a patched twin.

`SimulatedCrash` deliberately does NOT subclass `Exception`'s common
serving-error types: the schedulers treat it like any engine failure
(retry, then quarantine), while durability tests catch it to model a
process kill.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["FaultPlan", "InjectedFault", "SimulatedCrash"]


class InjectedFault(RuntimeError):
    """A fault-plan-injected engine failure (transient by construction:
    the same request retried on a later call succeeds unless the plan
    says otherwise)."""


class SimulatedCrash(RuntimeError):
    """The process 'died' at this exact point.  Durability tests catch
    this, drop every in-memory object, and recover from disk."""


@dataclass
class _EngineEvent:
    kind: str                       # error | kill | revive | straggle
    exc: BaseException | None = None
    shard: int = 0
    replica: int = 0
    delay_s: float = 0.0
    n: int = 1                      # how many consecutive calls it hits


@dataclass
class FaultPlan:
    """A deterministic schedule of runtime faults.

    Build one with the fluent helpers, then `install(collection)` —
    the plan wraps the collection's scheduler `run_batch` seam and (if a
    WAL is attached) the WAL's `fault_hook`.  Counters start at 1: the
    first engine call after install is call 1, the first WAL append
    after install is record 1.
    """

    clock: object | None = None     # VirtualClock for straggler delays
    _engine: dict = field(default_factory=dict)   # call_n -> [_EngineEvent]
    _wal: dict = field(default_factory=dict)      # record_n -> action str
    n_engine_calls: int = 0
    n_wal_records: int = 0

    # ------------------------------------------------------------ schedule

    def _add(self, call_n: int, ev: _EngineEvent) -> "FaultPlan":
        self._engine.setdefault(int(call_n), []).append(ev)
        return self

    def engine_error(self, at_call: int, exc: BaseException | None = None,
                     n: int = 1) -> "FaultPlan":
        """Raise from the engine on calls at_call .. at_call+n-1."""
        for i in range(n):
            self._add(at_call + i, _EngineEvent("error", exc=exc))
        return self

    def kill_shard(self, at_call: int, shard: int,
                   replica: int = 0) -> "FaultPlan":
        """Mark one shard replica down just before engine call N runs."""
        return self._add(at_call, _EngineEvent("kill", shard=shard,
                                               replica=replica))

    def revive_shard(self, at_call: int, shard: int,
                     replica: int = 0) -> "FaultPlan":
        return self._add(at_call, _EngineEvent("revive", shard=shard,
                                               replica=replica))

    def straggler(self, at_call: int, delay_s: float) -> "FaultPlan":
        """Advance the virtual clock by delay_s before call N — models a
        slow shard/step without real waiting."""
        return self._add(at_call, _EngineEvent("straggle", delay_s=delay_s))

    def crash_before_fsync(self, at_record: int) -> "FaultPlan":
        """WAL append N writes a torn half-record, then the process
        dies.  The op was never acked; recovery must drop the tail."""
        self._wal[int(at_record)] = "crash_before_fsync"
        return self

    def crash_after_fsync(self, at_record: int) -> "FaultPlan":
        """WAL append N is fully durable, then the process dies before
        the ack.  Recovery replays it (at-least-once on unacked ops)."""
        self._wal[int(at_record)] = "crash_after_fsync"
        return self

    # ------------------------------------------------------------- install

    def install(self, collection) -> None:
        """Wrap the collection's scheduler engine seam and WAL hook."""
        sched = collection.batcher
        inner = sched._run_batch
        health = getattr(collection, "health", None)
        if health is None:      # a bare backend instead of a Collection
            health = getattr(getattr(collection, "_backend", None),
                             "health", None)

        def run_batch(*args, **kw):
            self.n_engine_calls += 1
            for ev in self._engine.get(self.n_engine_calls, ()):
                if ev.kind == "kill" and health is not None:
                    health.kill(ev.shard, ev.replica)
                elif ev.kind == "revive" and health is not None:
                    health.revive(ev.shard, ev.replica)
                elif ev.kind == "straggle" and self.clock is not None:
                    self.clock.advance(ev.delay_s)
                elif ev.kind == "error":
                    raise ev.exc or InjectedFault(
                        f"injected engine fault at call "
                        f"{self.n_engine_calls}")
            return inner(*args, **kw)

        sched._run_batch = run_batch
        wal = getattr(collection, "_wal", None)
        if wal is not None:
            wal.fault_hook = self.wal_hook

    def wal_hook(self, seq: int, op: str) -> str | None:
        """The WAL-side seam: called once per append, returns the crash
        action for this record (or None).  Usable directly as the
        `fault_hook` of a hand-constructed `WriteAheadLog`."""
        self.n_wal_records += 1
        return self._wal.get(self.n_wal_records)
