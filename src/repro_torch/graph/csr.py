"""Fixed-degree CSR mirror of the host HNSW graph (DESIGN.md §15).

A copy of `repro.graph.csr` (numpy only): the same host graph gives the
same padded rows and the same `to_arrays()` in both packages.

`core.hnsw.HNSW` stays the single source of truth for graph *structure*
— construction, eager delta inserts, delete-with-repair all mutate the
host object.  `CSRGraph` is a derived, device-layout mirror of it:
padded fixed-degree neighbor rows (`-1` marks empty slots) that a
batched traversal can gather from with constant shapes, plus
enough bookkeeping (`levels`, `meta`, an `X` copy) to reconstruct the
host graph's `to_arrays()` encoding bit-for-bit.

Layout
  neigh0   (R, M0)      int32   layer-0 neighbor rows, -1 padded
  neigh_up (LU, R, M)   int32   layers 1..n_layers-1 (LU is a padded
                                layer capacity so a new top layer does
                                not change array ranks)
  levels   (R,)         int32   host per-node level; -1 = deleted or
                                absent (rows >= n)
  X        (R, d)       f32     host vector copy (inf for deleted rows)

R is a power-of-two row capacity chosen by the caller (the runtime
backend passes its row bucket so traversal shapes track the store's),
so incremental inserts refresh rows in place and the device arrays
reupload at the same shapes; R or LU overflow forces a rebuild at the
next bucket, exactly like every other bucketed array in the repo.

Invariant inherited from the host graph: `links[lev][node]` is non-None
iff `0 <= lev <= levels[node]`, which is what lets `to_arrays` rebuild
the exact offsets stream (including `-1` absent markers) from the
padded rows alone.
"""

from __future__ import annotations

import numpy as np

from ..core.hnsw import HNSW
from ..kernels.common import next_bucket

__all__ = ["CSRGraph"]


class CSRGraph:
    def __init__(self, d: int, M: int, efC: int, R: int, LU: int):
        self.d = d
        self.M = M
        self.M0 = 2 * M
        self.efC = efC
        self.R = int(R)
        self.LU = int(LU)
        self.n = 0
        self.n_layers = 0
        self.entry = -1
        self.max_level = -1
        self.neigh0 = np.full((self.R, self.M0), -1, np.int32)
        self.neigh_up = np.full((self.LU, self.R, self.M), -1, np.int32)
        self.levels = np.full(self.R, -1, np.int32)
        self.X = np.zeros((self.R, d), np.float32)

    # ------------------------------------------------------------ build

    @classmethod
    def from_hnsw(cls, h: HNSW, R: int | None = None,
                  LU: int | None = None) -> "CSRGraph":
        """Full mirror build.  R/LU default to power-of-two buckets with
        headroom so the eager insert path refreshes in place."""
        n = h.size
        if R is None:
            R = next_bucket(max(n, 1), minimum=64)
        if R < n:
            raise ValueError(f"row capacity {R} < graph size {n}")
        n_up = max(len(h.links) - 1, 0)
        if LU is None:
            LU = next_bucket(max(n_up, 1), minimum=4)
        if LU < n_up:
            raise ValueError(f"layer capacity {LU} < {n_up} upper layers")
        g = cls(h.dim, h.M, h.efC, R, LU)
        g.refresh_rows(h, range(n))
        g.refresh_meta(h)
        return g

    def fits(self, h: HNSW) -> bool:
        """Can this mirror absorb the host graph's current shape by
        row refreshes alone (no array reallocation)?"""
        return h.size <= self.R and max(len(h.links) - 1, 0) <= self.LU

    # -------------------------------------------------- incremental sync

    def refresh_rows(self, h: HNSW, rows) -> None:
        """Re-copy the given node ids' neighbor rows / level / vector
        from the host graph — the whole incremental-update surface:
        `on_insert` passes the new node plus its selected neighbors,
        `on_delete` passes the repaired in-neighbors."""
        for node in rows:
            node = int(node)
            lvl = h.levels[node] if node < h.size else -1
            self.levels[node] = lvl
            self.X[node] = h._X[node]
            row0 = h.links[0][node] if (h.links and lvl >= 0) else None
            self.neigh0[node] = -1
            if row0 is not None and row0.size:
                self.neigh0[node, : row0.size] = row0
            for li in range(self.LU):
                self.neigh_up[li, node] = -1
                lev = li + 1
                if lev < len(h.links) and 0 <= lev <= lvl:
                    up = h.links[lev][node]
                    if up is not None and up.size:
                        self.neigh_up[li, node, : up.size] = up

    def refresh_meta(self, h: HNSW) -> None:
        self.n = h.size
        self.n_layers = len(h.links)
        self.entry = int(h.entry)
        self.max_level = int(h.max_level)

    # ------------------------------------------------------- persistence

    def to_arrays(self) -> dict:
        """Rebuild the host graph's exact `to_arrays()` encoding from the
        padded rows (bit-identical: same flat/offsets stream, dtypes,
        and meta — the `.ppcol` round-trip contract)."""
        flat: list[int] = []
        offsets: list[int] = []
        for lev in range(self.n_layers):
            rows = self.neigh0 if lev == 0 else self.neigh_up[lev - 1]
            for node in range(self.n):
                if not 0 <= lev <= self.levels[node]:
                    offsets.append(-1)
                    continue
                row = rows[node]
                cnt = int((row >= 0).sum())
                offsets.append(len(flat))
                flat.append(cnt)
                flat.extend(int(v) for v in row[:cnt])
        return {
            "X": self.X[: self.n].copy(),
            "levels": np.asarray(self.levels[: self.n], np.int32).copy(),
            "flat": np.asarray(flat, np.int32),
            "offsets": np.asarray(offsets, np.int64),
            "meta": np.asarray(
                [self.M, self.efC, self.entry, self.max_level, self.n,
                 self.n_layers]),
        }

    @classmethod
    def from_arrays(cls, arrs: dict, R: int | None = None,
                    LU: int | None = None) -> "CSRGraph":
        """Inverse of `to_arrays` via the host decoder — one decoding
        path, so the mirror cannot drift from `HNSW.from_arrays`."""
        return cls.from_hnsw(HNSW.from_arrays(dict(arrs)), R=R, LU=LU)
