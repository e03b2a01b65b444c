"""Paper core, as far as the flat and graph filter-and-refine paths need
it: DCE, DCPE, the owner's HNSW, the secure k-NN refines, the wire frame
and the scheme's roles."""

from . import dce, dcpe, hnsw, ppanns, secure_knn, wireformat  # noqa: F401
