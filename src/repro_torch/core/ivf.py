"""IVF (inverted-file) coarse partitioner.

Host-side numpy, a verbatim copy of `repro.core.ivf`: the same seed and
the same C_SAP give bit-identical centroids and lists in both packages.
The IVF backends of `serving.search_engine` probe it on the host and scan
the probed rows on the engine's device; the PQ codebook of `core.adc`
trains its subspaces with `kmeans`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["IVFIndex", "kmeans"]


def kmeans(X: np.ndarray, n_clusters: int, n_iters: int = 10, seed: int = 0):
    """Plain Lloyd's; returns (centroids (c, d), assignment (n,))."""
    rng = np.random.default_rng(seed)
    X = np.asarray(X, np.float32)
    n = X.shape[0]
    cent = X[rng.choice(n, size=min(n_clusters, n), replace=False)].copy()
    xn = (X * X).sum(1)
    assign = np.zeros(n, np.int64)
    for _ in range(n_iters):
        d = xn[:, None] - 2.0 * X @ cent.T + (cent * cent).sum(1)[None, :]
        assign = d.argmin(1)
        for c in range(cent.shape[0]):
            mask = assign == c
            if mask.any():
                cent[c] = X[mask].mean(0)
    return cent, assign


class IVFIndex:
    def __init__(self, n_clusters: int = 64, n_iters: int = 10, seed: int = 0):
        self.n_clusters = n_clusters
        self.n_iters = n_iters
        self.seed = seed
        self.centroids: np.ndarray | None = None
        self.lists: list[np.ndarray] = []

    def build(self, X: np.ndarray):
        self.centroids, assign = kmeans(X, self.n_clusters, self.n_iters,
                                        self.seed)
        self.lists = [np.where(assign == c)[0]
                      for c in range(self.centroids.shape[0])]
        return self

    def probe(self, q: np.ndarray, nprobe: int = 4) -> np.ndarray:
        """Candidate ids from the nprobe nearest partitions."""
        d = ((self.centroids - q) ** 2).sum(1)
        order = np.argsort(d)[:nprobe]
        if len(order) == 0:
            return np.zeros(0, np.int64)
        return np.concatenate([self.lists[c] for c in order])

    def partition_of(self, q: np.ndarray, nprobe: int = 4) -> np.ndarray:
        d = ((self.centroids - q) ** 2).sum(1)
        return np.argsort(d)[:nprobe]
