"""repro_torch.graph — the batched encrypted graph index on the card
(DESIGN.md §15), counterpart of `repro.graph`.

`csr` holds the fixed-degree CSR mirror of the owner-built HNSW
(bit-identical `to_arrays()` with `core.hnsw`); `traverse` the torch
lockstep walk (upper-layer greedy descent + layer-0 beam search, perf
and oblivious variants); `filter` the `SecureSearchEngine` backend.  The
f32 perf walk (upper-layer descent and layer-0 beam search) runs in one
launch of the graph_expand CUDA kernel, through its entry point
`kernels.graph_expand.ops.graph_topk`.
"""

from .csr import CSRGraph
from .filter import GraphFilter
from .traverse import beam_plan

__all__ = ["CSRGraph", "GraphFilter", "beam_plan"]
