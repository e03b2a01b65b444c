"""adc_topk — the quantized-ADC filter scan with its top-kp, as
hand-written CUDA kernels (`csrc/adc_topk.cu`: int8 and PQ).
`adc_topk.py` holds the dispatching wrappers (CUDA tensors launch the
kernels, CPU tensors run the plain versions of `ref.py`), `ops.py` the
`sq_knn` / `pq_knn` entry points and the IVF pool / oblivious scans."""
from .ops import (pq_knn, pq_oblivious_scan, pq_pool_scan,  # noqa: F401
                  sq_knn, sq_oblivious_scan, sq_pool_scan)
from . import ref  # noqa: F401
