"""Batched lockstep HNSW traversal over the CSR mirror, in PyTorch.

Counterpart of `repro.graph.traverse` (DESIGN.md §15).  Upper layers run
a lockstep greedy descent, layer 0 a lockstep best-first beam search —
each hop selects every query's closest unexpanded beam entry, gathers
its fixed-degree neighbor row, scores the edges, and merges into the
beam with one stable sort.  Every shape is a function of static buckets
only (row capacity R, beam capacity ef_cap, padded layer count LU):

  * invalid neighbor slots (`-1` padding) and tombstoned rows ride the
    `ok` validity stream as data — masked to +inf, never a shape;
  * the *effective* ef is data: beam slots >= ef are re-invalidated
    after every merge, so results are a pure function of `ef` and
    identical across beam-capacity buckets.

Edge scoring is a `quant` mode: "f32" exact ciphertext distances,
"int8"/"pq8" the ADC surrogate distances of the `core.adc` codebooks.

`traverse` is the plain version of the graph_expand CUDA kernel's
`graph_walk` entry, which runs the whole f32 perf walk (descent and
layer 0) on the card; `beam_layer0`, the plain version of its
`expand_layer0` entry, lives beside the kernel
(`kernels/graph_expand/ref.py`) and is re-exported here.
Ids equal the JAX walk's because every tie rule is kept: `jnp.argmin`
and `torch.argmin` both return the first minimum, and the merge is a
stable ascending sort (what `jax.lax.top_k` of the negated distances
gives), never `torch.topk`.

The loops are host loops: the early-exit conditions (`jnp.any(~done)`
in the JAX `while_loop`s) cost one `.item()` per step here.  On the card
the f32 perf walk runs inside the kernel, one warp per query; the int8,
pq8 and oblivious walks run these loops.

`oblivious=True` is the bounded-hop fixed-fanout variant of the
`hardened` profile: the loops always run their static trip counts and
the hop/edge counts are constants of the shapes.  Per-query termination
latches in both modes, so returned ids are bit-identical between the
perf and oblivious variants.
"""

from __future__ import annotations

import torch

from ..kernels.common import next_bucket
from ..kernels.graph_expand.ref import _INF, _score, beam_layer0

__all__ = ["graph_topk", "traverse", "upper_entry", "beam_layer0",
           "beam_plan", "GREEDY_BOUND"]

# Static trip-count ceiling of each upper layer's greedy descent (the
# climb strictly improves per step, so real paths are O(log n); the
# bound gives the oblivious variant a constant trip count).
GREEDY_BOUND = 64


def _climb(rows, ok, db, qd, cur, cur_d, quant: str, oblivious: bool,
           hops, edges):
    """Lockstep greedy descent over one upper layer's (R, M) rows:
    move to the argmin neighbor while it strictly improves.  Updates
    latch per query, so the early-exit and fixed-trip variants reach
    the same state."""
    M = rows.shape[1]
    done0 = cur < 0
    cur = torch.where(done0, 0, cur)
    done = done0
    for _ in range(GREEDY_BOUND):
        if not oblivious and not bool((~done).any()):
            break
        nbrs = rows[cur].long()                          # (nq, M)
        valid = nbrs >= 0
        safe = torch.where(valid, nbrs, 0)
        valid = valid & ok[safe]
        d = torch.where(valid, _score(quant, db, qd, safe), _INF)
        j = torch.argmin(d, dim=1, keepdim=True)         # first minimum
        best = torch.gather(d, 1, j)[:, 0]
        sel = torch.gather(safe, 1, j)[:, 0]
        better = (best < cur_d) & ~done
        cur = torch.where(better, sel, cur)
        cur_d = torch.where(better, best, cur_d)
        if oblivious:            # constant accounting: every query, full row
            hops = hops + 1
            edges = edges + M
        else:
            hops = hops + (~done).int()
            edges = edges + torch.where(done, 0, valid.sum(1)).int()
        done = done | ~better
    return torch.where(done0, -1, cur), cur_d, hops, edges


def beam_plan(kp: int, ef: int, minimum: int = 32):
    """Static shape plan of one traversal call: (ef_eff, ef_cap,
    max_hops).  ef_cap is the power-of-two beam capacity; max_hops
    bounds the layer-0 expansion count (the host walk expands ~ef
    nodes, so 4x ef_cap is generous slack)."""
    ef_eff = int(max(kp, ef))
    ef_cap = next_bucket(ef_eff, minimum=minimum)
    return ef_eff, ef_cap, 4 * ef_cap


def upper_entry(neigh_up, ok, db, qd, entry: int, *, quant: str = "f32",
                oblivious: bool = False):
    """Phase 1: greedy-descend the upper layers, top first, all queries
    in lockstep.  Layers above max_level hold only -1 rows, so running
    every padded layer is inert (it only adds one hop per layer per
    query, as in the JAX walk).  Returns (ep (nq,) int64 layer-0 entry
    per query (-1 if the graph is empty), ep_d (nq,) f32, hops (nq,)
    int32, edges (nq,) int32)."""
    nq = qd.shape[0]
    dev = qd.device
    hops = torch.zeros(nq, dtype=torch.int32, device=dev)
    edges = torch.zeros(nq, dtype=torch.int32, device=dev)
    entry = int(entry)
    cur = torch.full((nq,), max(entry, 0), dtype=torch.int64, device=dev)
    if entry >= 0:
        cur_d = torch.where(ok[cur], _score(quant, db, qd, cur[:, None])[:, 0],
                            _INF)
    else:
        cur_d = torch.full((nq,), _INF, dtype=torch.float32, device=dev)
    cur = torch.where(cur_d < _INF, cur, -1)
    for li in reversed(range(neigh_up.shape[0])):
        cur, cur_d, hops, edges = _climb(
            neigh_up[li], ok, db, qd, cur, cur_d, quant, oblivious,
            hops, edges)
    return cur, cur_d, hops, edges


def traverse(neigh0, neigh_up, ok, db, qd, entry: int, ef: int, *,
             kp: int, ef_cap: int, max_hops: int, quant: str = "f32",
             oblivious: bool = False):
    """The full batched walk.

    neigh0 (R, M0) / neigh_up (LU, R, M) int32, `-1` padded; ok (R,)
    bool row validity; db the scan arrays ("f32": (C,), "int8": (c8, cn),
    "pq8": (codes_t,)); qd the query operand ((nq, d) rows, int8 codes,
    or (nq, m, 256) tables); entry/ef ints.  All tensors on one device.

    Returns (cand (nq, kp) int32 with -1 fill, cand_d (nq, kp) f32
    (+inf fill), visited (nq, R) bool scan trace, hops (nq,) int32,
    edges (nq,) int32).
    """
    ep, ep_d, hops, edges = upper_entry(
        neigh_up, ok, db, qd, entry, quant=quant, oblivious=oblivious)
    return beam_layer0(
        neigh0, ok, db, qd, ep, ep_d, ef, kp=kp, ef_cap=ef_cap,
        max_hops=max_hops, quant=quant, oblivious=oblivious,
        hops=hops, edges=edges)


# The name of the JAX package's jitted entry point: the plain torch walk,
# whatever the device.  The serving route, which launches the
# graph_expand kernel on CUDA tensors, is `kernels.graph_expand.ops`.
graph_topk = traverse
