"""Public entry point of the batched graph walk.

Counterpart of `repro.kernels.graph_expand.ops.graph_topk`, routed as
the JAX package routes it:

  quant="f32", oblivious=False
      `graph_walk`: the upper-layer descent and the layer-0 beam search in
      one launch of the CUDA kernel for CUDA tensors, its plain version
      (the torch walk `graph.traverse.traverse`) for CPU tensors;
  otherwise
      the torch `graph.traverse.traverse` — the only path for the
      int8 / pq8 edge scoring and the oblivious (`hardened`) fixed-trip
      variant.

Both return the same contract: (cand (nq, kp) int32 -1 fill, cand_d
(nq, kp) f32 +inf fill, visited (nq, R) bool scan trace, hops (nq,),
edges (nq,)).  The kernel keeps every tie rule of the torch walk, so the
ids equal its ids wherever the fp32 distances do.
"""

from __future__ import annotations

from ...graph import traverse as _traverse
from ...obs.profiler import instrument as _instrument
from .graph_expand import expand_layer0, graph_walk

__all__ = ["graph_topk", "graph_walk", "expand_layer0"]


def graph_topk(neigh0, neigh_up, ok, db, qd, entry: int, ef: int, *,
               kp: int, ef_cap: int, max_hops: int, quant: str = "f32",
               oblivious: bool = False):
    """Batched graph walk; see `graph.traverse.traverse` for the array
    contract."""
    if quant != "f32" or oblivious:
        return _traverse.traverse(
            neigh0, neigh_up, ok, db, qd, entry, ef, kp=kp,
            ef_cap=ef_cap, max_hops=max_hops, quant=quant,
            oblivious=oblivious)
    (C,) = db
    beam_i, beam_d, visited, hops, edges = graph_walk(
        neigh0, neigh_up, ok, C, qd, entry, ef, ef_cap=ef_cap,
        max_hops=max_hops)
    return beam_i[:, :kp], beam_d[:, :kp], visited, hops, edges


graph_topk = _instrument("graph_expand.graph_topk", graph_topk)
