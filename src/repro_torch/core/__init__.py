"""Paper core, as far as the flat, IVF, ADC and graph filter-and-refine
paths need it: DCE, DCPE, the owner's HNSW, the IVF coarse quantizer, the
ADC codebooks, the secure k-NN refines, the wire frame and the scheme's
roles."""

from . import (adc, dce, dcpe, hnsw, ivf, ppanns, secure_knn,  # noqa: F401
               wireformat)
