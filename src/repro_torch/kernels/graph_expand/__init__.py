"""graph_expand — the batched graph filter's walk (upper-layer descent
and layer-0 beam search) as a hand-written CUDA kernel
(`csrc/graph_expand.cu`).  `graph_expand.py` holds the dispatching
wrappers of its two entries (CUDA tensors launch the kernel, CPU tensors
run the plain versions: `graph.traverse.traverse` for `graph_walk`,
`ref.beam_layer0` for `expand_layer0`), `ops.py` the `graph_topk` entry
point that routes between it and the torch walk."""
