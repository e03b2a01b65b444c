from .ops import knn, pairwise_sq_dists  # noqa: F401
from . import ref  # noqa: F401
