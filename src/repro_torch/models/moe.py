"""Token-choice top-k Mixture-of-Experts with sort-based capacity
dispatch, the counterpart of `repro.models.moe` in plain torch ops:

  router -> top-k -> flatten (T*k assignments) -> stable sort by expert
  -> rank within the expert -> capacity-bounded slots -> gather into an
  (E, C, D) dispatch buffer -> per-expert batched matmul -> each token's
  k contributions gathered back and summed in (t, j) order.

The order rules are the reference's, so the same assignments drop and
the combine sums in the same order: the top-k takes ties to the lower
expert index (`lax.top_k`), the sort by expert is stable (`jnp.argsort`),
and every dropped assignment goes to the drop bin E*C, which is cut.
As in the reference, every expert's weights are read whether or not a
token was routed to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["capacity", "moe_block", "aux_load_balance_loss"]


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Static per-expert capacity: cf * T * k / E, floored at 4."""
    c = int(cfg.moe_capacity_factor * n_tokens * cfg.experts_per_token
            / cfg.n_experts)
    return max(4, c)


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, in
    descending order with ties to the lower index (`torch.topk` promises
    no tie order on CUDA; a stable descending sort keeps index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _assign(sel, E: int, C: int):
    """sel: (T, k) experts of each token -> (order, slot, keep) of the
    T*k assignments sorted stably by expert: `order` their (t, j) index
    (flattened), `slot` e*C + rank within the expert, or the drop bin
    E*C where the rank reaches the capacity C, `keep` = not dropped."""
    flat_e = sel.reshape(-1)                                     # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    # rank of each assignment within its expert's group
    counts = torch.zeros(E, dtype=se.dtype, device=se.device)    # (E,)
    counts.scatter_add_(0, se, torch.ones_like(se))   # bincount, meta too
    seg_start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(se.shape[0], device=sel.device) - seg_start[se]
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)               # drop bin
    return order, slot, keep


def moe_block(x, params, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D); params: router (D,E), wg/wu (E,D,F),
    wo (E,F,D)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, T)
    xf = x.reshape(T, D)
    dev = x.device

    # ---- routing (fp32)
    logits = xf.float() @ params["router"].float()               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, sel = _top_k(probs, k)                                    # (T, k)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)

    # ---- sort assignments by expert, capacity-bounded slots
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_w = w.reshape(-1)
    order, slot, keep = _assign(sel, E, C)
    st = flat_t[order]

    # ---- dispatch: slot -> source assignment, then gather the rows
    inv = torch.full((E * C + 1,), T * k, dtype=torch.long, device=dev)
    inv[slot] = torch.arange(T * k, device=dev)
    inv = inv[:-1]                                               # (E*C,)
    valid = inv < T * k
    src_tok = torch.where(valid, st[inv.clamp(max=T * k - 1)], 0)
    h_in = xf[src_tok] * valid[:, None].to(x.dtype)              # (E*C, D)
    h_in = h_in.reshape(E, C, D)

    # ---- per-expert ffn (swiglu)
    g = torch.bmm(h_in, params["wg"].to(x.dtype))
    u = torch.bmm(h_in, params["wu"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    out = torch.bmm(h, params["wo"].to(x.dtype))

    # ---- combine: gather each token's k contributions (no scatter-add)
    contrib = out.reshape(E * C, D)
    rank_of_flat = torch.argsort(order)                          # (T*k,)
    slot_of_flat = slot[rank_of_flat]
    w_of_flat = (flat_w * keep[rank_of_flat]).to(x.dtype)
    picked = contrib[slot_of_flat.clamp(max=E * C - 1)]          # (T*k, D)
    picked = torch.where((slot_of_flat < E * C)[:, None], picked, 0.0)
    y = (picked * w_of_flat[:, None]).reshape(T, k, D).sum(dim=1)
    return y.reshape(B, S, D)


def aux_load_balance_loss(x, params, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (fraction * prob per
    expert)."""
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1).float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    sel = torch.argmax(probs, dim=-1)               # ties to the first
    frac = F.one_hot(sel, cfg.n_experts).float().mean(dim=0)
    mean_p = probs.mean(dim=0)
    return cfg.n_experts * torch.sum(frac * mean_p)
