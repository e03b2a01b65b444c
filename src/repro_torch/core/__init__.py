"""Paper core: DCE, DCPE, the owner's HNSW, the IVF coarse quantizer, the
ADC codebooks, the secure k-NN refines, the wire frame, the scheme's
roles, the ASPE strawman with its KPA attacks (`aspe`, `attacks`), and
the AME and LSH baselines (`ame`, `lsh`)."""

from . import (adc, ame, aspe, attacks, dce, dcpe, hnsw, ivf,  # noqa: F401
               lsh, ppanns, secure_knn, wireformat)
