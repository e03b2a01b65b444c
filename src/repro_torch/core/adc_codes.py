"""The int8 / pq8 code format on the device, behind one owner (DESIGN.md
§11; port-only).  `ADCFilter`, `graph.GraphFilter`, `DeltaAwareBackend`
and `ShardedBackend` hold their codes in one `SQCodes` or `PQCodes`
(`make`): the codebook (`core.adc`) and `arrays`, the row axis of each
in `axes` -- int8 (c8 (n, d) int8, cn (n,) int32) on axis 0, pq8
(codes_t (m, n) uint8,) on axis 1.  That tuple is the graph walk's `db`,
`kind` its `quant` tag.  The caller places the arrays (`put`, `write`):
tensors, or `RowSharded` blocks (`shard(s)`).  The query operand: int8
uploads the float32 queries and quantizes them where they lie
(`adc_topk.sq_encode_queries`, the codebook's codes bit for bit, with
the codebook's offset uploaded once a device); pq8 builds its tables on the
host by the codebook, as the reference does, and uploads them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.adc_topk import ops as adc_ops
from ..obs.trace import child_span
from . import adc

__all__ = ["SQCodes", "PQCodes", "make", "refine_ratio", "oversampled"]


def refine_ratio(quantization: str | None, ratio=None) -> float:
    """`ratio`, or the kind's default oversampling (1.0 for f32)."""
    return (adc.default_refine_ratio(quantization) if ratio is None
            else float(ratio))


def oversampled(kp: int, ratio: float) -> int:
    """The ADC recall model: k' asked, max(k', ceil(k' ratio)) refined."""
    return max(kp, int(np.ceil(kp * ratio)))


def _pad(a: np.ndarray, bucket: int, axis: int) -> np.ndarray:
    if a.shape[axis] == bucket:
        return np.ascontiguousarray(a)
    buf = np.zeros(a.shape[:axis] + (bucket,) + a.shape[axis + 1:], a.dtype)
    buf[(slice(None),) * axis + (slice(0, a.shape[axis]),)] = a
    return buf


class _Codes:
    kind: str
    axes: tuple

    def __init__(self):
        self.codebook = None
        self.arrays: tuple | None = None

    def train(self, C: np.ndarray, *, m: int, seed: int):
        """Train (keylessly) and hold a codebook over the rows C."""
        self.codebook = adc.train_codebook(C, self.kind, m=m, seed=seed)
        return self.codebook

    @property
    def row_bytes(self) -> int:
        return self.codebook.code_bytes_per_vector()

    def encode(self, C: np.ndarray, bucket: int, put) -> None:
        """Free the arrays held, then encode the rows C into new ones of
        `bucket` rows (zeros past C), each placed by put(array, axis)."""
        self.arrays = None
        self.arrays = tuple(put(_pad(a, bucket, ax), ax)
                            for a, ax in zip(self._rows(C), self.axes))

    def append(self, C: np.ndarray, lo: int, write) -> None:
        """Encode the rows C into rows lo: of the arrays held, through
        write(dst, lo, hi, rows, axis)."""
        for dst, a, ax in zip(self.arrays, self._rows(C), self.axes):
            write(dst, lo, lo + a.shape[ax], a, ax)

    def shard(self, s: int) -> tuple:
        return tuple(a.shard(s) for a in self.arrays)

    # the `adc_topk.ops` scans (`<_ops>_<scan>`) over the arrays held, or
    # over `db` (a shard's blocks)

    def _scan(self, scan: str, db, *args):
        op = getattr(adc_ops, f"{self._ops}_{scan}")
        return op(*(db or self.arrays), *args)

    def knn(self, qop, k: int, ok, db=None):
        knn = getattr(adc_ops, f"{self._ops}_knn")
        return knn(qop, *(db or self.arrays), k, ok=ok)

    def pool_dists(self, qop, cand, valid, db=None):
        return self._scan("pool_dists", db, qop, cand, valid)

    def pool_scan(self, qop, cand, valid, kp: int, db=None):
        return self._scan("pool_scan", db, qop, cand, valid, kp)

    def oblivious_dists(self, qop, member, db=None):
        return self._scan("oblivious_dists", db, qop, member)

    def oblivious_scan(self, qop, member, kp: int, db=None):
        return self._scan("oblivious_scan", db, qop, member, kp)


class SQCodes(_Codes):
    kind, axes, _ops = "int8", (0, 0), "sq"

    @property
    def codebook(self):
        return self._codebook

    @codebook.setter
    def codebook(self, codebook):
        """A new codebook (trained or installed) drops the offsets that the
        old one uploaded."""
        self._codebook = codebook
        self._offsets = {}

    def _rows(self, C):
        return self.codebook.encode(C)          # (codes, cn)

    def _offset(self, dev) -> torch.Tensor:
        """The codebook's offset (d,) float32 on dev, uploaded once a
        device."""
        offset = self._offsets.get(dev)
        if offset is None:
            offset = self._offsets[dev] = torch.from_numpy(
                np.asarray(self.codebook.offset, np.float32)).to(dev)
        return offset

    def query_operand(self, Q: np.ndarray, dev) -> torch.Tensor:
        """q8 (nq, d) int8 on dev, the codebook's `encode_query` codes bit
        for bit, inside the `filter.query_prep` span: the float32 queries
        uploaded, then quantized there (the card's kernel on the stream,
        no sync; on the host its plain version)."""
        with child_span("filter.query_prep"):
            Qd = torch.from_numpy(np.ascontiguousarray(Q, np.float32)).to(dev)
            return adc_ops.sq_encode_queries(Qd, self._offset(Qd.device),
                                             self.codebook.scale)


class PQCodes(_Codes):
    kind, axes, _ops = "pq8", (1,), "pq"

    def _rows(self, C):
        return (self.codebook.encode(C).T,)

    def query_operand(self, Q: np.ndarray, dev) -> torch.Tensor:
        """The (nq, m, 256) float32 PQ tables, made by the codebook on the
        host and uploaded to dev inside the `filter.query_prep` span."""
        with child_span("filter.query_prep"):
            host = np.ascontiguousarray(self.codebook.lut(Q), np.float32)
            return torch.from_numpy(host).to(dev)


def make(quantization: str | None) -> _Codes | None:
    """The code holder of a quantization kind (validated by the caller),
    with no codebook yet; None for the f32 scan."""
    if quantization is None:
        return None
    return {"int8": SQCodes, "pq8": PQCodes}[quantization]()
