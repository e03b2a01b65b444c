from .ops import (batched_top_k_by_wins, batched_z_matrix,  # noqa: F401
                  refine_topk, top_k_by_wins, z_matrix)
from . import ref  # noqa: F401
