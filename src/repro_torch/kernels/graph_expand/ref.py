"""Plain PyTorch version of the graph_expand kernel's layer-0 entry
(`expand_layer0`): the layer-0 beam search of the batched graph walk,
with its edge scoring (exact f32, or the int8 / PQ ADC surrogates).
`graph.traverse` builds the full walk on it, the plain version of the
kernel's `graph_walk` entry (see its docstring for the tie rules that
keep the ids equal to the JAX walk's)."""

from __future__ import annotations

import torch

from ...device import full_fp32

__all__ = ["beam_layer0"]

_INF = float("inf")


def _score(quant: str, db, qd: torch.Tensor, ids: torch.Tensor):
    """Edge scores of `ids` (any (nq, W) int64, pre-clamped safe) for
    each query.  f32 is the host walk's exact formulation sum((x-q)^2)
    in float32 (db (C,), qd the queries; 16-bit rows and queries are
    upcast first, as the reference's kernel casts both to float32, so
    the difference and its square are never rounded to 16 bits); int8
    the float32 cn - 2 (q8 . c8), exact
    below 2^24 (db (c8, cn), qd the int8 queries); pq8 the table sum in
    ascending subspace order (db (codes_t,), qd the (nq, m, 256) tables).
    The ADC modes are rank surrogates, as in `repro.graph.traverse`."""
    if quant == "f32":
        (C,) = db
        rows = C[ids].to(torch.float32)                  # (nq, W, d)
        diff = rows - qd.to(torch.float32)[:, None, :]
        return (diff * diff).sum(-1)
    if quant == "int8":
        c8, cn = db
        full_fp32()
        rows = c8[ids].to(torch.float32)                 # (nq, W, d)
        cross = torch.einsum("qwd,qd->qw", rows, qd.to(torch.float32))
        return cn[ids].to(torch.float32) - 2.0 * cross
    if quant == "pq8":
        (codes_t,) = db                                  # (m, R) uint8
        out = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
        for j in range(codes_t.shape[0]):
            out = out + torch.gather(qd[:, j], 1, codes_t[j][ids].long())
        return out
    raise ValueError(f"unknown edge-scoring mode {quant!r}")


def beam_layer0(neigh0, ok, db, qd, ep, ep_d, ef: int, *, kp: int,
                ef_cap: int, max_hops: int, quant: str = "f32",
                oblivious: bool = False, hops=None, edges=None):
    """Phase 2: lockstep best-first beam search over the layer-0 rows,
    starting each query at its descent endpoint ep/ep_d.  The plain
    version of the graph_expand kernel's `expand_layer0` entry.

    Returns (cand (nq, kp) int32 with -1 fill, cand_d (nq, kp) f32
    (+inf fill), visited (nq, R) bool scan trace, hops (nq,) int32,
    edges (nq,) int32).
    """
    if not 1 <= kp <= ef_cap:
        raise ValueError(f"kp={kp} outside [1, ef_cap={ef_cap}]")
    nq = qd.shape[0]
    R, M0 = neigh0.shape
    dev = qd.device
    if hops is None:
        hops = torch.zeros(nq, dtype=torch.int32, device=dev)
    if edges is None:
        edges = torch.zeros(nq, dtype=torch.int32, device=dev)
    ep = ep.long()
    ep_ok = ep >= 0
    ep = torch.where(ep_ok, ep, 0)
    first = (torch.arange(ef_cap, device=dev)[None, :] == 0) & ep_ok[:, None]
    bd = torch.where(first, ep_d.float()[:, None], _INF)
    bi = torch.where(first, ep[:, None], -1)
    bx = ~first                                   # True = expanded/inert
    # visited as uint8 so the per-hop scatter can OR with "amax": every
    # invalid slot maps to row 0, and a plain index assignment with
    # those duplicates could write a 0 over a real neighbour 0's 1
    visited = torch.zeros((nq, R), dtype=torch.uint8, device=dev)
    visited.scatter_reduce_(1, ep[:, None], ep_ok[:, None].to(torch.uint8),
                            reduce="amax")
    done = ~ep_ok
    iota = torch.arange(ef_cap, device=dev)[None, :]
    over = iota >= ef                  # effective-ef truncation
    for _ in range(max_hops):
        if not oblivious and not bool((~done).any()):
            break
        du = torch.where(bx, _INF, bd)
        j = torch.argmin(du, dim=1, keepdim=True)         # first minimum
        sel_d = torch.gather(du, 1, j)[:, 0]
        sel_i = torch.gather(bi, 1, j)[:, 0]
        worst = bd[:, ef - 1]
        # host break rule: min unexpanded worse than the ef-th best (or
        # nothing left to expand)
        qdone = torch.isinf(sel_d) | (sel_d > worst)
        active = ~done & ~qdone

        sel_safe = torch.where(sel_i >= 0, sel_i, 0)
        nbrs = neigh0[sel_safe].long()                    # (nq, M0)
        valid = nbrs >= 0
        safe = torch.where(valid, nbrs, 0)
        valid = valid & ok[safe]
        seen = torch.gather(visited, 1, safe).bool()      # read before set
        fresh = valid & ~seen
        d = torch.where(fresh, _score(quant, db, qd, safe), _INF)
        visited.scatter_reduce_(1, safe,
                                (fresh & active[:, None]).to(torch.uint8),
                                reduce="amax")

        bx_sel = bx | (iota == j)                         # mark expanded
        cat_d = torch.cat([bd, d], dim=1)
        cat_i = torch.cat([bi, torch.where(fresh, safe, -1)], dim=1)
        cat_x = torch.cat([bx_sel, ~fresh], dim=1)
        perm = torch.sort(cat_d, dim=1, stable=True).indices[:, :ef_cap]
        nbd = torch.where(over, _INF, torch.gather(cat_d, 1, perm))
        nbi = torch.where(over, -1, torch.gather(cat_i, 1, perm))
        nbx = torch.gather(cat_x, 1, perm) | over

        am = active[:, None]
        bd = torch.where(am, nbd, bd)
        bi = torch.where(am, nbi, bi)
        bx = torch.where(am, nbx, bx)
        if oblivious:
            hops = hops + 1
            edges = edges + M0
        else:
            hops = hops + active.int()
            edges = edges + torch.where(active, fresh.sum(1), 0).int()
        done = done | qdone

    return (bi[:, :kp].int(), bd[:, :kp], visited.bool(), hops, edges)
