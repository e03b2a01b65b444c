"""Paper core, as far as the flat filter-and-refine path needs it: DCE,
DCPE, the secure k-NN refines, the wire frame and the scheme's roles."""

from . import dce, dcpe, ppanns, secure_knn, wireformat  # noqa: F401
