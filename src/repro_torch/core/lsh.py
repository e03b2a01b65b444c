"""E2LSH index — the baseline index of RS-SANN / PRI-ANN (paper §VII).

Standard p-stable locality-sensitive hashing: L tables of k concatenated
hashes h(x) = floor((a.x + b) / w).  The paper's comparison point is that
LSH needs far more candidates than HNSW for the same recall, which is what
drives RS-SANN/PRI-ANN's communication and user-side cost.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LSHIndex"]


class LSHIndex:
    def __init__(
        self,
        dim: int,
        n_tables: int = 8,
        n_hashes: int = 12,
        bucket_width: float = 4.0,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self.dim = dim
        self.L = n_tables
        self.k = n_hashes
        self.w = bucket_width
        self.A = rng.standard_normal((n_tables, dim, n_hashes)).astype(np.float32)
        self.b = rng.uniform(0, bucket_width, (n_tables, n_hashes)).astype(np.float32)
        self.tables: list[dict[bytes, list[int]]] = [dict() for _ in range(n_tables)]
        self._n = 0

    def _hash(self, X: np.ndarray) -> np.ndarray:
        """(n, d) -> (L, n, k) int32 bucket coordinates."""
        proj = np.einsum("nd,ldk->lnk", X.astype(np.float32), self.A)
        return np.floor((proj + self.b[:, None, :]) / self.w).astype(np.int32)

    def build(self, X: np.ndarray):
        H = self._hash(np.atleast_2d(X))
        for l in range(self.L):
            tab = self.tables[l]
            for i, hrow in enumerate(H[l]):
                tab.setdefault(hrow.tobytes(), []).append(self._n + i)
        self._n += X.shape[0]
        return self

    def query(self, q: np.ndarray) -> np.ndarray:
        """Union of bucket candidates across tables (unranked)."""
        H = self._hash(q[None])
        out: set[int] = set()
        for l in range(self.L):
            out.update(self.tables[l].get(H[l, 0].tobytes(), ()))
        return np.fromiter(out, np.int64, len(out))
