"""Async background `.ppcol` checkpointing (DESIGN.md §16), the
counterpart of `repro.resilience.checkpoint` (host code, copied; the
blob is the JAX package's format).

A checkpoint is `Collection.snapshot()` — which copies every array
*under the collection lock*, the copy-on-write step — serialized to one
versioned wireformat blob (kind "ppcol-checkpoint") and written
tmp + `os.replace`, so a crash mid-checkpoint leaves the previous
checkpoint intact.  The expensive parts (serialization, disk write,
fsync) run on a background thread: the serving path blocks only for the
in-memory array copies, never for I/O.

The snapshot's bookkeeping carries `wal_seq` — the WAL sequence number
of the last mutation the captured state includes, read under the same
lock hold — so recovery replays exactly the records after it, and a
durable checkpoint lets `WriteAheadLog.truncate_through(wal_seq)` drop
the log prefix it made redundant.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

import numpy as np

from ..core.wireformat import pack, unpack

__all__ = ["AsyncCheckpointer", "collection_state_bytes",
           "restore_collection_state", "CHECKPOINT_KIND",
           "CHECKPOINT_VERSION"]

CHECKPOINT_KIND = "ppcol-checkpoint"
CHECKPOINT_VERSION = 1


def collection_state_bytes(collection) -> bytes:
    """One self-contained checkpoint blob for a collection (arrays +
    bookkeeping, including `wal_seq` when a WAL is attached)."""
    arrays, bookkeeping = collection.snapshot()
    return pack(CHECKPOINT_KIND, CHECKPOINT_VERSION, arrays=arrays,
                meta=bookkeeping)


def restore_collection_state(collection, data: bytes) -> dict:
    """Load a checkpoint blob into an (empty, compatibly-specced)
    collection via `load_snapshot`; returns the bookkeeping meta (the
    caller reads `wal_seq` off it to know where replay starts).  The
    graph/ivf/adc sidecar decode mirrors `SecureAnnService.load` — the
    filter state that is not a pure function of the store rides the
    same prefixed arrays in both formats."""
    arrays, meta = unpack(data, CHECKPOINT_KIND, CHECKPOINT_VERSION)
    graph_arrays = {k[len("graph__"):]: v for k, v in arrays.items()
                    if k.startswith("graph__")} or None
    ivf_state = None
    if "ivf__centroids" in arrays:
        ivf_state = {
            "centroids": arrays["ivf__centroids"],
            "list_flat": arrays["ivf__list_flat"],
            "list_offsets": arrays["ivf__list_offsets"],
            "built_upto": meta["ivf_built_upto"],
            "attached_gen": meta["ivf_attached_gen"],
        }
    adc_arrays = {k[len("adc__"):]: v for k, v in arrays.items()
                  if k.startswith("adc__")}
    adc_state = ({"arrays": adc_arrays,
                  "trained_gen": meta["adc_trained_gen"]}
                 if adc_arrays else None)
    collection.load_snapshot(
        arrays["C_sap"], arrays["C_dce"],
        alive=np.asarray(arrays["alive"], bool),
        n_main=int(meta["n_main"]), main_gen=int(meta["main_gen"]),
        graph_arrays=graph_arrays, ivf_state=ivf_state,
        adc_state=adc_state)
    return dict(meta)


class AsyncCheckpointer:
    """Background checkpoint writer for one collection.

    `trigger()` captures the snapshot synchronously (array copies under
    the collection lock — the only part that can block a mutation) and
    hands serialization + tmp-write + `os.replace` + WAL truncation to
    a worker thread; it returns that thread so tests and shutdown paths
    can `join()`.  Checkpoints are serialized with respect to each
    other: a trigger while the previous write is in flight joins it
    first, so the newest state always wins the `os.replace`.

    `note_ops(n)` is the ops-count trigger seam: with `every_n_ops`
    set, the collection-side caller reports acknowledged mutations and
    a checkpoint fires automatically each time the counter crosses the
    interval.
    """

    def __init__(self, collection, path, *, wal=None,
                 every_n_ops: int | None = None):
        self.collection = collection
        self.path = Path(path)
        self.wal = wal if wal is not None \
            else getattr(collection, "_wal", None)
        self.every_n_ops = every_n_ops
        self._ops_since = 0
        self._worker: threading.Thread | None = None
        self._trigger_lock = threading.Lock()
        self.n_checkpoints = 0
        self.n_segments_truncated = 0
        self.last_wal_seq = -1

    # ------------------------------------------------------------ trigger

    def trigger(self) -> threading.Thread:
        """Start one background checkpoint; returns the worker thread."""
        with self._trigger_lock:
            if self._worker is not None and self._worker.is_alive():
                self._worker.join()
            arrays, book = self.collection.snapshot()
            self._ops_since = 0
            worker = threading.Thread(
                target=self._write, args=(arrays, book),
                name=f"ckpt-{self.path.name}", daemon=True)
            self._worker = worker
            worker.start()
            return worker

    def checkpoint(self) -> dict:
        """Synchronous convenience: trigger and wait for durability."""
        self.trigger().join()
        return {"wal_seq": self.last_wal_seq,
                "n_checkpoints": self.n_checkpoints}

    def note_ops(self, n: int = 1):
        """Report n acknowledged mutations; fires `trigger()` when the
        configured interval is crossed."""
        if self.every_n_ops is None:
            return
        self._ops_since += int(n)
        if self._ops_since >= self.every_n_ops:
            self.trigger()

    def join(self):
        """Wait for the in-flight checkpoint write, if any."""
        with self._trigger_lock:
            worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join()

    # ------------------------------------------------------------- worker

    def _write(self, arrays: dict, book: dict):
        data = pack(CHECKPOINT_KIND, CHECKPOINT_VERSION, arrays=arrays,
                    meta=book)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        seq = int(book.get("wal_seq", -1))
        if self.wal is not None and seq >= 0:
            self.n_segments_truncated += self.wal.truncate_through(seq)
        self.last_wal_seq = seq
        self.n_checkpoints += 1
        telemetry = getattr(self.collection, "telemetry", None)
        if telemetry is not None:
            telemetry.record_checkpoint()
