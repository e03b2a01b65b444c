"""Paper core: DCE, DCPE, the owner's HNSW, the IVF coarse quantizer, the
ADC codebooks, the secure k-NN refines, the wire frame, the scheme's
roles, and the ASPE strawman with its KPA attacks (`aspe`, `attacks`)."""

from . import (adc, aspe, attacks, dce, dcpe, hnsw, ivf,  # noqa: F401
               ppanns, secure_knn, wireformat)
