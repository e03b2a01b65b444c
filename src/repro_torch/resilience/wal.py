"""Crash-safe ingestion write-ahead log (DESIGN.md §16), the counterpart
of `repro.resilience.wal` (host code, copied): the frames and segment
files are the JAX package's byte for byte, so either package replays a
log the other wrote.

Ciphertext-only durability for live mutations: every acknowledged
`insert_encrypted` / `delete` / explicit `compact` on a collection
appends one record here *after* the in-memory store applied it and
*before* the ack returns, so

    acked  =>  durable (fsync'd)  =>  replayed on recovery.

The converse direction is the torn-tail rule: a record the process died
writing was never acked, so recovery may (must) drop it.

On-disk format — append-only segment files `wal-<firstseq>.seg`, each a
sequence of frames:

    +--------+--------+---------+---------+-----------------+
    | b"PWAL"| seq u64| len u32 | crc u32 | payload (len B) |
    +--------+--------+---------+---------+-----------------+

The payload is a versioned `core.wireformat` blob (kind "wal-record"):
the op name + op metadata ride the JSON header, the ciphertext arrays
(C_sap / C_dce rows for inserts, row ids for deletes) ride the npz
body — the WAL stores exactly what the server already holds, never
plaintext, so its leakage surface is the store's own (DESIGN.md §14).

Sequence numbers are global and monotonic across segments and across
reopens; segment filenames carry their first seq so `truncate_through`
(called after a durable checkpoint) can drop whole prefix segments
without reading them.  CRC validation on replay: a bad frame in the
*last* segment is a torn tail (clean stop, file truncated at reopen); a
bad frame anywhere else is real corruption and raises.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..core import wireformat
from .faults import SimulatedCrash

__all__ = ["WriteAheadLog", "WalRecord", "WalCorruptionError"]

_MAGIC = b"PWAL"
_HEADER = struct.Struct("<QII")            # seq, payload_len, crc32
_FRAME_OVERHEAD = len(_MAGIC) + _HEADER.size
WAL_VERSION = 1


class WalCorruptionError(RuntimeError):
    """A CRC/framing failure somewhere other than the final segment's
    tail — data loss beyond what a torn write can explain."""


@dataclass(frozen=True)
class WalRecord:
    """One replayable acknowledged mutation."""
    seq: int
    op: str                         # insert | delete | compact
    arrays: dict
    meta: dict

    @property
    def n_rows(self) -> int:
        if self.op == "insert":
            return int(self.arrays["C_sap"].shape[0])
        if self.op == "delete":
            return int(self.arrays["rows"].shape[0])
        return 0


def _segment_name(first_seq: int) -> str:
    return f"wal-{first_seq:016d}.seg"


class WriteAheadLog:
    """Append / replay / truncate over a directory of segment files.

    Thread safety: appends are serialized by the caller (the collection
    appends under its own mutation lock, the same lock that orders the
    mutations themselves — a second lock here could only disagree).

    `fault_hook(seq, op) -> action | None` is the deterministic
    fault-injection seam: "crash_before_fsync" makes this append write
    a torn half-frame and die; "crash_after_fsync" makes it durable and
    then die before the caller can ack.
    """

    def __init__(self, root, *, segment_bytes: int = 4 << 20,
                 fsync: bool = True, fault_hook=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self.fsync_enabled = bool(fsync)
        self.fault_hook = fault_hook
        self._f = None
        self._f_path: Path | None = None
        self.n_appended = 0
        self.last_seq = 0
        self._recover_tail()

    # -------------------------------------------------------------- open

    def _segments(self) -> list[Path]:
        return sorted(self.root.glob("wal-*.seg"))

    def _recover_tail(self):
        """Find the last valid seq; physically truncate a torn tail of
        the final segment so later appends/replays see clean frames."""
        segs = self._segments()
        for i, path in enumerate(segs):
            last = i == len(segs) - 1
            good_end, seq = self._scan_segment(path, last=last)
            if seq is not None:
                self.last_seq = seq
            if last and good_end < path.stat().st_size:
                with open(path, "r+b") as f:
                    f.truncate(good_end)

    def _scan_segment(self, path: Path, *, last: bool):
        """Returns (byte offset after the last valid frame, last seq in
        the segment or None).  Raises on mid-log corruption."""
        seq = None
        good_end = 0
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off < len(data):
            frame = self._parse_frame(data, off)
            if frame is None:
                if not last:
                    raise WalCorruptionError(
                        f"corrupt frame at {path.name}:{off} (not the "
                        f"final segment — cannot be a torn tail)")
                break
            off, seq = frame
            good_end = off
        return good_end, seq

    @staticmethod
    def _parse_frame(data: bytes, off: int):
        """(next_offset, seq) for a valid frame at off, else None."""
        end = off + _FRAME_OVERHEAD
        if end > len(data) or data[off: off + len(_MAGIC)] != _MAGIC:
            return None
        seq, length, crc = _HEADER.unpack_from(data, off + len(_MAGIC))
        payload_end = end + length
        if payload_end > len(data):
            return None
        if zlib.crc32(data[end:payload_end]) != crc:
            return None
        return payload_end, seq

    # ------------------------------------------------------------ append

    def _file_for(self, frame_len: int):
        """Current segment file, rotating when it would overflow."""
        if self._f is not None:
            if self._f.tell() + frame_len <= self.segment_bytes \
                    or self._f.tell() == 0:
                return self._f
            self._f.close()
            self._f = None
        path = self.root / _segment_name(self.last_seq + 1)
        self._f = open(path, "ab")
        self._f.seek(0, os.SEEK_END)   # 'ab' tell() is 0 on some libcs
        self._f_path = path
        return self._f

    def append(self, op: str, arrays: dict | None = None,
               meta: dict | None = None) -> int:
        """Durably log one acknowledged mutation; returns its seq."""
        seq = self.last_seq + 1
        payload = wireformat.pack(
            "wal-record", WAL_VERSION,
            {k: np.asarray(v) for k, v in (arrays or {}).items()},
            {"op": op, **(meta or {})})
        frame = (_MAGIC
                 + _HEADER.pack(seq, len(payload), zlib.crc32(payload))
                 + payload)
        f = self._file_for(len(frame))
        action = self.fault_hook(seq, op) if self.fault_hook else None
        if action == "crash_before_fsync":
            f.write(frame[: max(1, len(frame) // 2)])
            f.flush()
            raise SimulatedCrash(
                f"died mid-write of WAL record {seq} (torn tail)")
        f.write(frame)
        f.flush()
        if action == "crash_after_fsync":
            os.fsync(f.fileno())
            raise SimulatedCrash(
                f"died after fsync of WAL record {seq} (durable, unacked)")
        if self.fsync_enabled:
            os.fsync(f.fileno())
        self.last_seq = seq
        self.n_appended += 1
        return seq

    # ------------------------------------------------------------ replay

    def replay(self, after_seq: int = 0):
        """Yield `WalRecord`s with seq > after_seq, oldest first."""
        segs = self._segments()
        for i, path in enumerate(segs):
            with open(path, "rb") as f:
                data = f.read()
            off = 0
            while off < len(data):
                frame = self._parse_frame(data, off)
                if frame is None:
                    if i != len(segs) - 1:
                        raise WalCorruptionError(
                            f"corrupt frame at {path.name}:{off}")
                    return          # torn tail: clean stop
                payload_end, seq = frame
                if seq > after_seq:
                    arrays, m = wireformat.unpack(
                        data[off + _FRAME_OVERHEAD: payload_end],
                        "wal-record", WAL_VERSION)
                    meta = dict(m or {})
                    op = meta.pop("op")
                    yield WalRecord(seq=seq, op=op, arrays=dict(arrays),
                                    meta=meta)
                off = payload_end

    # ---------------------------------------------------------- truncate

    def truncate_through(self, seq: int) -> int:
        """Drop whole segments made redundant by a checkpoint that
        captured every mutation up to and including `seq`.  Returns the
        number of segment files deleted.  (Granularity is the segment:
        a segment straddling `seq` survives intact — replaying already-
        checkpointed inserts is prevented by the caller replaying only
        records with seq > checkpoint seq.)"""
        segs = self._segments()
        removed = 0
        for i, path in enumerate(segs):
            nxt_first = (int(segs[i + 1].stem.split("-")[1])
                         if i + 1 < len(segs) else self.last_seq + 1)
            if nxt_first - 1 <= seq and path != self._f_path:
                path.unlink()
                removed += 1
            else:
                break               # segments are ordered; stop early
        return removed

    # ------------------------------------------------------------- close

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
