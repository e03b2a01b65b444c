"""Approximate-distance-computation (ADC) codebooks over DCPE
ciphertexts (DESIGN.md §11).

A copy of `repro.core.adc`: the same ciphertexts and seed give
bit-identical codebooks, codes, query codes and look-up tables in both
packages.  One change: `PQCodebook.encode` walks the rows in chunks of
`_ENCODE_CHUNK`, because the reference's (n, 256, d/m) float32
temporaries reach gigabytes at a million rows; each row's argmin sees
the same arithmetic, so the codes are unchanged.

The filter phase only needs distances *approximately* — exactness lives
in the DCE refine — yet the flat/IVF backends stream full-precision f32
DCPE ciphertexts at 4 bytes/dim.  This module trains server-side
codebooks that compress those ciphertexts to 1 byte/dim (int8 scalar
quantization) or m bytes/vector (m-subspace product quantization,
k=256 centroids per subspace, Faiss/ScaNN-style), cutting filter
bandwidth 4-32x.

Privacy: training and encoding are *keyless* — a codebook is a
deterministic function of the DCPE ciphertexts the honest-but-curious
server already stores, exactly like the IVF centroids and the HNSW
graph.  No new leakage is created (DESIGN.md §11).

Recall model: quantized distances mis-rank near-ties, so the filter
oversamples — it returns k' * refine_ratio candidates into the
unchanged exact DCE refine, which restores the order (defaults: int8
2x, pq8 4x).

Scalar (int8) quantization uses per-dim offsets with one *global*
scale, so the symmetric integer distance

    ||c8_i - q8||^2  ~  ||c_i - q||^2 / scale^2

is rank-equivalent to a pure int32 expression `cn_i - 2 * (q8 . c8_i)`
— the form the adc_topk CUDA kernel computes with int8 dot products
into int32 (kernels/adc_topk).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ivf import kmeans

__all__ = ["QUANTIZATIONS", "DEFAULT_REFINE_RATIO", "SQCodebook",
           "PQCodebook", "train_codebook", "codebook_from_arrays",
           "default_refine_ratio", "pq_subspaces"]

# None is "no quantization" (the f32 scan); the strings are the
# IndexSpec.quantization vocabulary.
QUANTIZATIONS = (None, "int8", "pq8")

# Oversampling defaults of the recall model above: filter k' is
# multiplied by this before the exact refine.
DEFAULT_REFINE_RATIO = {"int8": 2.0, "pq8": 4.0}

_PQ_K = 256                      # centroids per subspace (1-byte codes)
_ENCODE_CHUNK = 65536            # rows per step of PQCodebook.encode


def default_refine_ratio(quantization: str | None) -> float:
    if quantization is None:
        return 1.0
    return DEFAULT_REFINE_RATIO[quantization]


def pq_subspaces(d: int, m: int) -> int:
    """Largest subspace count <= m that divides d (PQ needs equal
    subvector widths; d=128, m=16 -> 16 subspaces of 8 dims)."""
    m = max(1, min(int(m), d))
    while d % m:
        m -= 1
    return m


@dataclasses.dataclass
class SQCodebook:
    """int8 scalar quantization: c8 = round((c - offset) / scale).

    offset: (d,) per-dim midranges; scale: one global float (per-dim
    scales would break the rank-equivalent integer distance — see the
    module docstring).  `cn` returned by `encode` is the int32 code
    norm ||c8||^2, the precomputed term of the ADC distance (4 bytes
    per row next to d bytes of codes).
    """
    offset: np.ndarray
    scale: float
    trained_n: int = 0
    kind: str = dataclasses.field(default="int8", init=False)

    @classmethod
    def train(cls, C: np.ndarray) -> "SQCodebook":
        C = np.atleast_2d(np.asarray(C, np.float32))
        lo, hi = C.min(axis=0), C.max(axis=0)
        offset = (lo + hi) / 2.0
        spread = float(np.abs(C - offset).max())
        return cls(offset=offset.astype(np.float32),
                   scale=max(spread, 1e-12) / 127.0,
                   trained_n=C.shape[0])

    @property
    def d(self) -> int:
        return self.offset.shape[0]

    def code_bytes_per_vector(self) -> int:
        return self.d + 4               # int8 codes + int32 norm

    def encode(self, C: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """-> (codes (n, d) int8, cn (n,) int32 code norms)."""
        C = np.atleast_2d(np.asarray(C, np.float32))
        q = np.rint((C - self.offset[None, :]) / self.scale)
        codes = np.clip(q, -127, 127).astype(np.int8)
        cn = (codes.astype(np.int32) ** 2).sum(axis=1, dtype=np.int64)
        return codes, cn.astype(np.int32)

    def encode_query(self, Q: np.ndarray) -> np.ndarray:
        """Symmetric query quantization (same grid as the codes)."""
        codes, _ = self.encode(Q)
        return codes

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return codes.astype(np.float32) * self.scale + self.offset[None, :]

    def to_arrays(self) -> dict:
        return {"offset": self.offset,
                "scale": np.float64(self.scale),   # full-precision: the
                # grid must round-trip bit-identically (DESIGN.md §11)
                "trained_n": np.int64(self.trained_n)}

    @classmethod
    def from_arrays(cls, arrays: dict) -> "SQCodebook":
        return cls(offset=np.asarray(arrays["offset"], np.float32),
                   scale=float(arrays["scale"]),
                   trained_n=int(arrays["trained_n"]))


@dataclasses.dataclass
class PQCodebook:
    """m-subspace product quantization, k=256 centroids per subspace.

    centroids: (m, 256, d/m) f32.  A database row encodes to m uint8
    centroid ids; a query becomes an (m, 256) look-up table of partial
    squared distances, and ADC is a LUT gather-accumulate over codes —
    the adc_topk CUDA kernel keeps each query's LUT in shared memory.
    """
    centroids: np.ndarray
    trained_n: int = 0
    kind: str = dataclasses.field(default="pq8", init=False)

    @classmethod
    def train(cls, C: np.ndarray, m: int = 16, seed: int = 0,
              n_iters: int = 8) -> "PQCodebook":
        C = np.atleast_2d(np.asarray(C, np.float32))
        n, d = C.shape
        m = pq_subspaces(d, m)
        sub = d // m
        k = min(_PQ_K, n)
        cents = np.zeros((m, _PQ_K, sub), np.float32)
        for j in range(m):
            cj, _ = kmeans(C[:, j * sub: (j + 1) * sub], k,
                           n_iters=n_iters, seed=seed + j)
            cents[j, : cj.shape[0]] = cj
            if cj.shape[0] < _PQ_K:     # tiny corpus: duplicate the
                cents[j, cj.shape[0]:] = cj[0]   # first centroid so
                # every code stays decodable (never selected: argmin
                # picks the original copy first)
        return cls(centroids=cents, trained_n=n)

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def d(self) -> int:
        return self.m * self.centroids.shape[2]

    def code_bytes_per_vector(self) -> int:
        return self.m                   # one uint8 id per subspace

    def encode(self, C: np.ndarray) -> np.ndarray:
        """-> (n, m) uint8 centroid ids."""
        C = np.atleast_2d(np.asarray(C, np.float32))
        n, d = C.shape
        sub = d // self.m
        codes = np.zeros((n, self.m), np.uint8)
        for s in range(0, n, _ENCODE_CHUNK):
            Cs = C[s: s + _ENCODE_CHUNK]
            for j in range(self.m):
                X = Cs[:, j * sub: (j + 1) * sub]
                cj = self.centroids[j]
                d2 = ((X[:, None, :] - cj[None]) ** 2).sum(-1)
                codes[s: s + Cs.shape[0], j] = d2.argmin(1).astype(np.uint8)
        return codes

    def decode(self, codes: np.ndarray) -> np.ndarray:
        codes = np.atleast_2d(np.asarray(codes))
        parts = [self.centroids[j, codes[:, j].astype(np.int64)]
                 for j in range(self.m)]
        return np.concatenate(parts, axis=1)

    def lut(self, Q: np.ndarray) -> np.ndarray:
        """Per-query ADC table: (nq, m, 256) partial squared distances."""
        Q = np.atleast_2d(np.asarray(Q, np.float32))
        nq, d = Q.shape
        sub = d // self.m
        Qs = Q.reshape(nq, self.m, 1, sub)
        return ((Qs - self.centroids[None]) ** 2).sum(-1)

    def to_arrays(self) -> dict:
        return {"centroids": self.centroids,
                "trained_n": np.int64(self.trained_n)}

    @classmethod
    def from_arrays(cls, arrays: dict) -> "PQCodebook":
        return cls(centroids=np.asarray(arrays["centroids"], np.float32),
                   trained_n=int(arrays["trained_n"]))


def train_codebook(C: np.ndarray, quantization: str, *, m: int = 16,
                   seed: int = 0):
    """Server-side (keyless) codebook training over DCPE ciphertexts."""
    if quantization == "int8":
        return SQCodebook.train(C)
    if quantization == "pq8":
        return PQCodebook.train(C, m=m, seed=seed)
    raise ValueError(f"unknown quantization {quantization!r} "
                     f"(have {QUANTIZATIONS})")


def codebook_from_arrays(quantization: str, arrays: dict):
    """Inverse of `<codebook>.to_arrays` keyed by the quantization kind
    (the `.ppcol` restore path)."""
    if quantization == "int8":
        return SQCodebook.from_arrays(arrays)
    if quantization == "pq8":
        return PQCodebook.from_arrays(arrays)
    raise ValueError(f"unknown quantization {quantization!r} "
                     f"(have {QUANTIZATIONS})")
