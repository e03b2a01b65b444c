"""Public wrappers around the l2_topk kernels.

`knn` scans the database once and keeps a running top-k, so no (nq, n)
distance matrix is ever materialized: the counterpart of
`repro.kernels.l2_topk.ops.knn`.  On the card it is one fused kernel
call; on CPU tensors it is the plain chunked merge (`ref.scan_knn`).  `knn` is wrapped by the opt-in kernel profiler
(`obs.profiler`), a passthrough unless profiling is active.
"""

from __future__ import annotations

from ...obs.profiler import instrument as _instrument
from .l2_topk import knn, pairwise_sq_dists

__all__ = ["knn", "pairwise_sq_dists"]


knn = _instrument("l2_topk.knn", knn)
