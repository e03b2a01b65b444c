"""Transformer building blocks of every family, the counterpart of
`repro.models.layers` in plain torch ops.

Conventions (those of the reference):
  * Parameters are read by name from a mapping (`params["wq"]`,
    `params.get("bq")`): a dict of tensors or a `transformer.ParamGroup`.
  * Attention projections are stored fused 2-D, (d_model, n_heads*d_head),
    in the reference's orientation: `x @ w`, no transpose.
  * Norm statistics, softmax and attention logits are computed in
    float32; activations and products stay in the input's dtype
    (`x @ w.to(x.dtype)`).
  * Masked attention logits are -1e30, as in the reference.

On one card nothing is placed: the reference's `constrain` is the
identity without a mesh, so the port calls none.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["rms_norm", "layer_norm", "norm", "rope", "attn_core",
           "attention", "mlp", "embed", "unembed", "FLASH_THRESHOLD",
           "FLASH_KV_CHUNK"]


# ------------------------------------------------------------------ norms

def rms_norm(x, scale, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps: float):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def norm(x, params, cfg: ModelConfig):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rms_norm(x, params["scale"], cfg.norm_eps)


# ------------------------------------------------------------------- rope

def rope(x, positions, *, fraction: float = 1.0, theta: float = 10_000.0):
    """Rotary embedding on the leading `fraction` of head dims.

    x: (B, S, H, dh); positions: (B, S) integer.  chatglm3's "2d rope" is
    the fraction=0.5 case (rotary on half the dims, pass-through on the
    rest).  The angles and the rotation are float32.
    """
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[:, :, None, None] * freq     # (B,S,1,half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    out = torch.cat([xr1, xr2, x_pass.float()], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention

FLASH_THRESHOLD = 2048      # chunk KV when S > 1 and T exceeds this
FLASH_KV_CHUNK = 512
MASKED = -1e30


def _mask_block(q_positions, t_idx, kv_valid_len, causal, prefix_len):
    """(B,1,1,S,c) boolean allowed-mask for a KV block at absolute t_idx,
    or None where everything is allowed."""
    t = t_idx[None, None, None, None, :]
    ok = None
    if causal:
        qp = q_positions[:, None, None, :, None]
        ok = (t <= qp) | (t < prefix_len)
    if kv_valid_len is not None:
        valid = t < kv_valid_len[:, None, None, None, None]
        ok = valid if ok is None else ok & valid
    return ok


def _masked(logits, ok):
    return logits if ok is None else torch.where(ok, logits, MASKED)


def attn_core(q, k, v, *, q_positions, kv_valid_len=None, causal=True,
              prefix_len=0):
    """Grouped-query attention core.

    q: (B, S, H, dh); k, v: (B, T, K, dh) with H = K * G.  Never repeats
    KV: logits are computed in the (K, G) factored form, in float32.

    Long sequences (S > 1, T > FLASH_THRESHOLD and T a multiple of
    FLASH_KV_CHUNK) take the reference's KV-chunked branch: a running
    max, sum and accumulator over 512-row chunks, so the (S, T) logits
    never materialize.  The branch condition is the reference's, so both
    packages sum in the same order.

    q_positions: (B, S) absolute positions of the queries.
    kv_valid_len: (B,) or None — number of valid cache rows (T laid out
      from absolute position 0).
    prefix_len: bidirectional prefix (PaliGemma prefix-LM).
    """
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, S, K, G, dh).float()
    kf = k.float()
    vf = v.float()
    scale = 1.0 / math.sqrt(dh)

    if S > 1 and T > FLASH_THRESHOLD and T % FLASH_KV_CHUNK == 0:
        c = FLASH_KV_CHUNK
        m = torch.full((B, K, G, S), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, K, G, S, dh), dtype=torch.float32,
                          device=q.device)
        for ci in range(T // c):
            ks = kf[:, ci * c:(ci + 1) * c]
            vs = vf[:, ci * c:(ci + 1) * c]
            logits = torch.einsum("bskgd,btkd->bkgst", qf, ks) * scale
            t_idx = torch.arange(ci * c, (ci + 1) * c, device=q.device)
            logits = _masked(logits, _mask_block(
                q_positions, t_idx, kv_valid_len, causal, prefix_len))
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p, vs)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]    # (B,K,G,S,dh)
        out = out.movedim(3, 1).reshape(B, S, H, dh)
        return out.to(q.dtype)

    logits = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
    t_idx = torch.arange(T, device=q.device)
    logits = _masked(logits, _mask_block(q_positions, t_idx, kv_valid_len,
                                         causal, prefix_len))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, vf)
    return out.reshape(B, S, H, dh).to(q.dtype)


def attention(x, params, cfg: ModelConfig, *, q_positions, x_kv=None,
              cache=None, causal=True, prefix_len=0, use_rope=True):
    """Attention block body (no residual / pre-norm — caller owns).

    x_kv: the cross-attention source (whisper's encoder output), or None
      for self-attention.  Rope applies only when `use_rope` and x_kv is
      None.
    cache: None; {"k", "v": (B, T_max, K, dh), "pos": int} — the new K/V
      rows are written in place at [pos, pos + S), which the caller has
      checked lies inside T_max; or {"xk", "xv": (B, Se, K, dh)} — the
      precomputed cross K/V, read and never written (x_kv may then be
      None).  `prefix_len` rows attend bidirectionally.
    Returns (out (B,S,D), {"k","v"} or None).
    """
    B, S, _ = x.shape
    H, dh, K = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads

    def proj(src, w, b, n):
        y = src @ w.to(src.dtype)
        if b is not None:
            y = y + b.to(src.dtype)
        return y.reshape(src.shape[0], src.shape[1], n, dh)

    q = proj(x, params["wq"], params.get("bq"), H)
    if cache is not None and "xk" in cache:
        k, v = cache["xk"], cache["xv"]
    else:
        src = x if x_kv is None else x_kv
        k = proj(src, params["wk"], params.get("bk"), K)
        v = proj(src, params["wv"], params.get("bv"), K)

    if cfg.qk_norm:  # qwen3: per-head RMSNorm before rope
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)

    if use_rope and x_kv is None:
        # new K rows share the query positions (contiguous decode/prefill)
        q = rope(q, q_positions, fraction=cfg.rope_fraction,
                 theta=cfg.rope_theta)
        k = rope(k, q_positions, fraction=cfg.rope_fraction,
                 theta=cfg.rope_theta)

    kv_valid = None
    new_cache = None
    if cache is not None and "k" in cache:
        pos = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        ck[:, pos:pos + S] = k.to(ck.dtype)
        cv[:, pos:pos + S] = v.to(cv.dtype)
        k, v = ck, cv
        kv_valid = torch.full((B,), pos + S, dtype=torch.int32,
                              device=x.device)
        new_cache = {"k": ck, "v": cv}

    out = attn_core(q, k, v, q_positions=q_positions, kv_valid_len=kv_valid,
                    causal=causal, prefix_len=prefix_len)
    out = out.reshape(B, S, H * dh)
    y = out @ params["wo"].to(out.dtype)
    if params.get("bo") is not None:
        y = y + params["bo"].to(y.dtype)
    return y, new_cache


# -------------------------------------------------------------------- mlp

def mlp(x, params, cfg: ModelConfig):
    if cfg.mlp_type == "swiglu":
        g = x @ params["wg"].to(x.dtype)
        u = x @ params["wu"].to(x.dtype)
        h = F.silu(g.float()).to(x.dtype) * u
    elif cfg.mlp_type == "squared_relu":     # nemotron-4
        h = x @ params["wi"].to(x.dtype)
        h = torch.square(torch.relu(h.float())).to(x.dtype)
    elif cfg.mlp_type == "gelu":             # whisper; jax.nn.gelu's tanh form
        h = x @ params["wi"].to(x.dtype)
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(cfg.mlp_type)
    return h @ params["wo"].to(x.dtype)


# -------------------------------------------------------------- embedding

def embed(tokens, table):
    return table[tokens]


def unembed(x, tokens_table, kernel, cfg: ModelConfig):
    """Logits in x's dtype: against the token table when the embeddings
    are tied, else against the unembedding kernel (D, V)."""
    if cfg.tie_embeddings:
        return x @ tokens_table.to(x.dtype).T
    return x @ kernel.to(x.dtype)
