"""Hand-written CUDA kernels for the search path, with their wrappers.

l2_topk      — filter-phase squared-L2 distance tiles + streaming k-NN
dce_comp     — refine-phase batched DCE DistanceComp (pairwise Z) tiles
graph_expand — the batched HNSW graph walk (descent + layer-0 beam search)
adc_topk     — quantized (int8 / PQ) ADC filter scan + fused top-kp

Each kernel directory carries the dispatching wrapper (`<name>.py`:
CUDA tensors launch the kernel from `csrc/`, CPU tensors run the plain
version), `ops.py` (the public functions built on it) and `ref.py` (the
plain PyTorch versions).
"""
