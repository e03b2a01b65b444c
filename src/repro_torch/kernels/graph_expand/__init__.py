"""graph_expand — the layer-0 beam search of the batched graph filter as
a hand-written CUDA kernel (`csrc/graph_expand.cu`).  `graph_expand.py`
holds the dispatching wrapper (CUDA tensors launch the kernel, CPU
tensors run the plain version, `ref.beam_layer0`), `ops.py` the
`graph_topk` entry point that routes between it and the torch walk."""
