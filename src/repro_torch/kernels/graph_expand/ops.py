"""Public entry point of the batched graph walk.

Counterpart of `repro.kernels.graph_expand.ops.graph_topk`, routed as
the JAX package routes it:

  quant="f32", oblivious=False
      upper layers descend in torch ops (`graph.traverse.upper_entry`,
      a handful of lockstep greedy steps), then `expand_layer0` runs the
      layer-0 beam search: the CUDA kernel for CUDA tensors, its plain
      version for CPU tensors;
  otherwise
      the torch `graph.traverse.traverse` — the only path for the
      oblivious (`hardened`) fixed-trip variant.

Both return the same contract: (cand (nq, kp) int32 -1 fill, cand_d
(nq, kp) f32 +inf fill, visited (nq, R) bool scan trace, hops (nq,),
edges (nq,)).  The kernel's merge keeps the stable-sort tie order, so
the ids equal the torch walk's wherever the fp32 distances do.
"""

from __future__ import annotations

from ...graph import traverse as _traverse
from .graph_expand import expand_layer0

__all__ = ["graph_topk", "expand_layer0"]


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
    ep, ep_d, hops, edges = _traverse.upper_entry(
        neigh_up, ok, db, qd, entry, quant="f32", oblivious=False)
    beam_i, beam_d, visited, k_hops, k_edges = expand_layer0(
        neigh0, ok, C, qd, ep, ep_d, ef, ef_cap=ef_cap, max_hops=max_hops)
    return (beam_i[:, :kp], beam_d[:, :kp], visited,
            hops + k_hops, edges + k_edges)
