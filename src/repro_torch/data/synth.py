"""Synthetic datasets with exact ground truth.

The container is offline, so the paper's SIFT/GIST/Glove/Deep datasets are
replaced by clustered Gaussians of the *same dimensionalities* (128 / 960 /
100 / 96).  Clustered (not iid) data is essential: iid Gaussians in high d
have near-constant pairwise distances, which makes ANN trivially hard and
un-representative; mixtures reproduce the local-neighborhood structure that
HNSW exploits.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["VectorDataset", "make_dataset", "PAPER_DIMS", "ground_truth",
           "recall_at_k"]

# dims matching the paper's datasets (Table I)
PAPER_DIMS = {"sift1m": 128, "gist": 960, "glove": 100, "deep1m": 96}


@dataclasses.dataclass
class VectorDataset:
    name: str
    base: np.ndarray      # (n, d) database vectors
    queries: np.ndarray   # (nq, d)
    gt: np.ndarray        # (nq, k_gt) exact NN ids (ascending distance)

    @property
    def n(self) -> int:
        return self.base.shape[0]

    @property
    def d(self) -> int:
        return self.base.shape[1]


def ground_truth(base: np.ndarray, queries: np.ndarray, k: int,
                 chunk: int = 2048) -> np.ndarray:
    """Exact brute-force k-NN ids, chunked over the base set."""
    base = np.asarray(base, np.float32)
    queries = np.asarray(queries, np.float32)
    nq = queries.shape[0]
    qn = (queries * queries).sum(1)[:, None]
    best_d = np.full((nq, k), np.inf, np.float32)
    best_i = np.full((nq, k), -1, np.int64)
    for start in range(0, base.shape[0], chunk):
        xs = base[start:start + chunk]
        d = qn - 2.0 * queries @ xs.T + (xs * xs).sum(1)[None, :]
        cat_d = np.concatenate([best_d, d], axis=1)
        cat_i = np.concatenate(
            [best_i, np.broadcast_to(start + np.arange(xs.shape[0])[None, :],
                                     (nq, xs.shape[0]))], axis=1)
        sel = np.argsort(cat_d, axis=1)[:, :k]
        best_d = np.take_along_axis(cat_d, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
    return best_i


def make_dataset(
    name: str = "sift1m",
    n: int = 20_000,
    n_queries: int = 100,
    k_gt: int = 100,
    n_clusters: int = 64,
    cluster_std: float = 0.35,
    seed: int = 0,
    d: int | None = None,
) -> VectorDataset:
    """Clustered-Gaussian stand-in for the paper's datasets."""
    d = d or PAPER_DIMS[name]
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 2.0
    assign = rng.integers(0, n_clusters, size=n)
    base = centers[assign] + cluster_std * rng.standard_normal(
        (n, d)).astype(np.float32)
    qassign = rng.integers(0, n_clusters, size=n_queries)
    queries = centers[qassign] + cluster_std * rng.standard_normal(
        (n_queries, d)).astype(np.float32)
    gt = ground_truth(base, queries, min(k_gt, n))
    return VectorDataset(name=name, base=base, queries=queries, gt=gt)


def recall_at_k(found_ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Recall@k = |found ∩ exact| / k, averaged over queries (paper §VII)."""
    found_ids = np.atleast_2d(found_ids)
    gt = np.atleast_2d(gt)[:, :k]
    hits = 0
    for f, g in zip(found_ids, gt):
        hits += len(set(f[:k].tolist()) & set(g.tolist()))
    return hits / (gt.shape[0] * k)
