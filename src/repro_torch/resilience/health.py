"""Shard-replica health registry (DESIGN.md §16), the counterpart of
`repro.resilience.health` (host numpy and a lock, copied).

One (n_shards, n_replicas) boolean up-matrix behind a lock, plus a
monotonic epoch that bumps on every transition — the epoch is the cache
key the sharded backend uses to rebuild its row-serve masks only when
health actually changed, keeping the healthy steady state allocation-
and rebuild-free.

Semantics (replicas are logical copies of a shard's row block, one
physical array):

  * a shard *group* is servable while >= 1 of its replicas is up;
  * `serve_mask()[s]` is False only when every replica of shard s is
    down — exactly the shards whose rows degraded-mode answers omit;
  * `n_groups_down` / `degraded` feed `SearchStats.n_shards_down` /
    `SearchStats.degraded` on every answer served while unhealthy.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["ShardHealthRegistry"]


class ShardHealthRegistry:
    """Thread-safe up/down state for an (n_shards x n_replicas) group."""

    def __init__(self, n_shards: int, n_replicas: int = 1):
        if n_shards < 1 or n_replicas < 1:
            raise ValueError("n_shards and n_replicas must be >= 1")
        self.n_shards = int(n_shards)
        self.n_replicas = int(n_replicas)
        self._up = np.ones((self.n_shards, self.n_replicas), dtype=bool)
        self._lock = threading.Lock()
        self.epoch = 0

    def _check(self, shard: int, replica: int):
        if not (0 <= shard < self.n_shards):
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.n_shards})")
        if not (0 <= replica < self.n_replicas):
            raise ValueError(f"replica {replica} out of range "
                             f"[0, {self.n_replicas})")

    def kill(self, shard: int, replica: int = 0) -> None:
        self._check(shard, replica)
        with self._lock:
            if self._up[shard, replica]:
                self._up[shard, replica] = False
                self.epoch += 1

    def revive(self, shard: int, replica: int = 0) -> None:
        self._check(shard, replica)
        with self._lock:
            if not self._up[shard, replica]:
                self._up[shard, replica] = True
                self.epoch += 1

    def is_up(self, shard: int, replica: int = 0) -> bool:
        self._check(shard, replica)
        with self._lock:
            return bool(self._up[shard, replica])

    def serve_mask(self) -> np.ndarray:
        """(n_shards,) bool: True where >= 1 replica is up."""
        with self._lock:
            return self._up.any(axis=1).copy()

    @property
    def n_groups_down(self) -> int:
        with self._lock:
            return int((~self._up.any(axis=1)).sum())

    @property
    def n_replicas_down(self) -> int:
        with self._lock:
            return int((~self._up).sum())

    @property
    def degraded(self) -> bool:
        """True when at least one shard group has no live replica —
        answers omit those rows and must say so."""
        return self.n_groups_down > 0

    @property
    def healthy(self) -> bool:
        """True when every replica of every shard is up."""
        with self._lock:
            return bool(self._up.all())

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "epoch": self.epoch,
                "up": self._up.copy(),
                "n_groups_down": int((~self._up.any(axis=1)).sum()),
                "n_replicas_down": int((~self._up).sum()),
            }
