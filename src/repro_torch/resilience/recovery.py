"""Kill-restart recovery: checkpoint restore + WAL replay (DESIGN.md
§16), the counterpart of `repro.resilience.recovery` (host code,
copied).

The recovery contract: every mutation the old process *acknowledged* is
either inside the checkpoint (its seq <= the checkpoint's `wal_seq`) or
an fsync'd WAL record after it — so

    recover() = load checkpoint + replay records with seq > wal_seq

reproduces the acknowledged state bit-identically, including tombstone
layout, main/delta split, and generation counters.  Replay drives the
collection's *public* mutation methods with the WAL detached, so
derived state (auto-compaction thresholds, IVF delta assignment, graph
repair order) re-derives exactly as it did live; the WAL is re-attached
afterwards so post-recovery mutations keep logging with contiguous
sequence numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .checkpoint import restore_collection_state
from .wal import WriteAheadLog

__all__ = ["recover", "RecoveryReport", "attach_wal"]


@dataclass(frozen=True)
class RecoveryReport:
    """What `recover()` did — the numbers the durability tests assert
    on."""
    had_checkpoint: bool
    checkpoint_seq: int             # wal_seq the checkpoint covered (0 = none)
    n_replayed: int                 # WAL records applied
    n_rows_replayed: int            # rows inserted/deleted by replay
    last_seq: int                   # WAL position after recovery


def attach_wal(collection, wal: WriteAheadLog) -> None:
    """Attach a WAL to a live collection: from now on every acknowledged
    insert/delete/compact appends one durable record before the ack."""
    collection.attach_wal(wal)


def recover(make_collection, *, checkpoint_path=None, wal_dir=None,
            attach: bool = True):
    """Rebuild a collection after a kill.

    make_collection: zero-arg factory returning a fresh, empty
        collection with the same spec the dead process ran (backend,
        seed, placement, compact_every — recovery replays through the
        public mutation path, so derived state needs the same knobs).
    checkpoint_path: the `AsyncCheckpointer` target (may not exist yet
        — recovery then replays the WAL from the beginning).
    wal_dir: the `WriteAheadLog` directory (may be empty/missing).
    attach: re-attach the WAL to the recovered collection so new
        mutations keep logging (pass False for read-only forensics).

    Returns (collection, RecoveryReport).
    """
    col = make_collection()
    had_checkpoint = False
    after_seq = 0
    if checkpoint_path is not None and Path(checkpoint_path).exists():
        meta = restore_collection_state(
            col, Path(checkpoint_path).read_bytes())
        after_seq = int(meta.get("wal_seq", 0))
        had_checkpoint = True
    n_replayed = 0
    n_rows = 0
    wal = None
    if wal_dir is not None:
        wal = WriteAheadLog(wal_dir)
        for rec in wal.replay(after_seq=after_seq):
            if rec.op == "insert":
                col.insert_encrypted(rec.arrays["C_sap"],
                                     rec.arrays["C_dce"])
            elif rec.op == "delete":
                col.delete(np.asarray(rec.arrays["rows"], np.int64))
            elif rec.op == "compact":
                col.compact()
            else:
                raise ValueError(f"unknown WAL op {rec.op!r} "
                                 f"(seq {rec.seq})")
            n_replayed += 1
            n_rows += rec.n_rows
    report = RecoveryReport(
        had_checkpoint=had_checkpoint, checkpoint_seq=after_seq,
        n_replayed=n_replayed, n_rows_replayed=n_rows,
        last_seq=wal.last_seq if wal is not None else after_seq)
    telemetry = getattr(col, "telemetry", None)
    if telemetry is not None and n_replayed:
        telemetry.record_wal_replay(n_replayed)
    if wal is not None:
        if attach:
            col.attach_wal(wal)
        else:
            wal.close()
    return col, report
