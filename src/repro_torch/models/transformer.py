"""Family assembly: parameter metas, the module tree that holds the
weights, name-based initialization, and forward / prefill / decode for
dense / moe / vlm (decoder-only), ssm (mamba2), hybrid (zamba2) and
encdec (whisper) — the counterpart of `repro.models.transformer`.

The reference stacks each layer weight on a leading L axis and scans
over it; the port holds one `Layer` module a layer in an
`nn.ModuleList` and loops.  `param_metas` keeps the reference's stacked
shapes (the single source of truth for both), and `convert.py` moves
weights between the two layouts.  `loss_fn` is the reference's
next-token cross entropy; with `cfg.remat` each layer body of a
cache-free pass (training's) runs under
`torch.utils.checkpoint.checkpoint`, as the reference wraps it in
`jax.checkpoint`: its activations are recomputed in the backward pass,
which changes memory and never the numbers.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..sharding.rules import ParamMeta
from . import layers as L
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig

__all__ = ["DTYPES", "param_metas", "ParamGroup", "Layer", "make_params",
           "init_params", "forward", "loss_fn", "prefill", "decode_step"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

DECODER_FAMILIES = ("dense", "moe", "vlm")


# =====================================================================
# Param metas (the reference's shapes, with the leading L axis)
# =====================================================================

def _fs(cfg: ModelConfig):
    """Logical axis for ZeRO-3 weight sharding of the d_model dim."""
    return "embed_fsdp" if cfg.fsdp else None


def _pm(stack: int | None, dt: str):
    def pm(shape, axes):
        if stack is not None:
            shape = (stack,) + shape
            axes = (None,) + axes
        return ParamMeta(shape, axes, dt)
    return pm


def _attn_metas(cfg: ModelConfig, stack: int | None, dt: str) -> dict:
    pm = _pm(stack, dt)
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    fs = _fs(cfg)
    out = {
        "wq": pm((D, H * dh), (fs, "heads")),
        "wk": pm((D, K * dh), (fs, "kv")),
        "wv": pm((D, K * dh), (fs, "kv")),
        "wo": pm((H * dh, D), ("heads", fs)),
    }
    if cfg.qkv_bias:
        out |= {"bq": pm((H * dh,), ("heads",)),
                "bk": pm((K * dh,), ("kv",)),
                "bv": pm((K * dh,), ("kv",))}
    if cfg.qk_norm:
        out |= {"q_norm": pm((dh,), (None,)),
                "k_norm": pm((dh,), (None,))}
    return out


def _mlp_metas(cfg: ModelConfig, stack: int | None, dt: str) -> dict:
    pm = _pm(stack, dt)
    D, F = cfg.d_model, cfg.d_ff
    fs = _fs(cfg)
    if cfg.mlp_type == "swiglu":
        return {"wg": pm((D, F), (fs, "ff")), "wu": pm((D, F), (fs, "ff")),
                "wo": pm((F, D), ("ff", fs))}
    return {"wi": pm((D, F), (fs, "ff")), "wo": pm((F, D), ("ff", fs))}


def _moe_metas(cfg: ModelConfig, stack: int | None, dt: str) -> dict:
    pm = _pm(stack, dt)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    fs = _fs(cfg)
    return {
        "router": pm((D, E), (None, None)),
        "wg": pm((E, D, F), ("expert", fs, "ff")),
        "wu": pm((E, D, F), ("expert", fs, "ff")),
        "wo": pm((E, F, D), ("expert", "ff", fs)),
    }


def _norm_metas(cfg: ModelConfig, stack: int | None, dt: str) -> dict:
    pm = _pm(stack, dt)
    out = {"scale": pm((cfg.d_model,), (None,))}
    if cfg.norm_type == "layernorm":
        out["bias"] = pm((cfg.d_model,), (None,))
    return out


def _ssm_metas(cfg: ModelConfig, stack: int | None, dt: str) -> dict:
    pm = _pm(stack, dt)
    D, dI = cfg.d_model, cfg.d_inner
    GN = cfg.ssm_groups * cfg.ssm_state
    H = cfg.ssm_heads
    kw = cfg.ssm_conv
    fs = _fs(cfg)
    return {
        "wz": pm((D, dI), (fs, "ssm_inner")),
        "wx": pm((D, dI), (fs, "ssm_inner")),
        "wb": pm((D, GN), (fs, None)),
        "wc": pm((D, GN), (fs, None)),
        "wdt": pm((D, H), (fs, None)),
        "conv": pm((kw, dI + 2 * GN), (None, "conv_dim")),
        "a_log": pm((H,), (None,)),
        "dt_bias": pm((H,), (None,)),
        "d_skip": pm((H,), (None,)),
        "norm_scale": pm((dI,), ("ssm_inner",)),
        "wo": pm((dI, D), ("ssm_inner", fs)),
    }


def _block_metas(cfg: ModelConfig, stack: int | None, dt: str,
                 mlp: dict) -> dict:
    """attn_norm / attn / mlp_norm / mlp: a decoder layer or zamba2's
    shared block."""
    return {"attn_norm": _norm_metas(cfg, stack, dt),
            "attn": _attn_metas(cfg, stack, dt),
            "mlp_norm": _norm_metas(cfg, stack, dt), "mlp": mlp}


def param_metas(cfg: ModelConfig) -> dict:
    dt = cfg.dtype
    V, D = cfg.vocab_size, cfg.d_model
    Ls = cfg.n_layers if cfg.scan_layers else None
    metas: dict[str, Any] = {
        "embed": {"tokens": ParamMeta((V, D), ("vocab", _fs(cfg)), dt)},
        "final_norm": _norm_metas(cfg, None, dt),
    }
    if not cfg.tie_embeddings:
        metas["unembed"] = {"kernel": ParamMeta((D, V), (_fs(cfg), "vocab"),
                                                dt)}
    if cfg.family in DECODER_FAMILIES:
        metas["layers"] = _block_metas(
            cfg, Ls, dt, _moe_metas(cfg, Ls, dt) if cfg.family == "moe"
            else _mlp_metas(cfg, Ls, dt))
    elif cfg.family in ("ssm", "hybrid"):
        metas["layers"] = {"norm": _norm_metas(cfg, Ls, dt),
                           "mixer": _ssm_metas(cfg, Ls, dt)}
        if cfg.family == "hybrid":
            metas["shared"] = _block_metas(cfg, None, dt,
                                           _mlp_metas(cfg, None, dt))
    elif cfg.family == "encdec":
        Le = cfg.n_enc_layers if cfg.scan_layers else None
        metas["encoder"] = {
            "layers": _block_metas(cfg, Le, dt, _mlp_metas(cfg, Le, dt)),
            "final_norm": _norm_metas(cfg, None, dt),
        }
        metas["layers"] = {
            "attn_norm": _norm_metas(cfg, Ls, dt),
            "attn": _attn_metas(cfg, Ls, dt),
            "cross_norm": _norm_metas(cfg, Ls, dt),
            "cross": _attn_metas(cfg, Ls, dt),
            "mlp_norm": _norm_metas(cfg, Ls, dt),
            "mlp": _mlp_metas(cfg, Ls, dt),
        }
    else:
        raise ValueError(cfg.family)
    return metas


# =====================================================================
# The module tree
# =====================================================================

class ParamGroup(nn.Module):
    """One group of named weights (a leaf dict of the reference's tree),
    read like that dict: `group["wq"]`, `group.get("bq")`."""

    def __init__(self, metas: dict[str, ParamMeta], dtype, device,
                 stacked: bool = False):
        super().__init__()
        for name, m in metas.items():
            shape = m.shape[1:] if stacked else m.shape
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]

    def get(self, name: str, default=None):
        return self._parameters.get(name, default)


class Layer(nn.Module):
    """One layer's weights: a `ParamGroup` for each group of the metas
    (`attn_norm/attn/mlp_norm/mlp`, `norm/mixer`, or
    `attn_norm/attn/cross_norm/cross/mlp_norm/mlp`).  `stacked`: the
    metas carry the reference's leading L axis, which is dropped."""

    def __init__(self, metas: dict, dtype, device, stacked: bool = True):
        super().__init__()
        for name, group in metas.items():
            self.add_module(name, ParamGroup(group, dtype, device,
                                             stacked=stacked))


def make_params(module: nn.Module, cfg: ModelConfig, device) -> None:
    """Register the weights of `cfg` on `module` (uninitialized):
    `embed`, `final_norm`, `unembed` (untied only), `layers`, and
    `shared` (hybrid) or `encoder.layers` / `encoder.final_norm`
    (encdec)."""
    metas = param_metas(cfg)
    dtype = DTYPES[cfg.dtype]
    module.embed = ParamGroup(metas["embed"], dtype, device)
    module.final_norm = ParamGroup(metas["final_norm"], dtype, device)
    module.unembed = (ParamGroup(metas["unembed"], dtype, device)
                      if "unembed" in metas else None)
    module.layers = nn.ModuleList(
        Layer(metas["layers"], dtype, device) for _ in range(cfg.n_layers))
    if "shared" in metas:
        module.shared = Layer(metas["shared"], dtype, device, stacked=False)
    if "encoder" in metas:
        enc = metas["encoder"]
        module.encoder = nn.Module()
        module.encoder.layers = nn.ModuleList(
            Layer(enc["layers"], dtype, device)
            for _ in range(cfg.n_enc_layers))
        module.encoder.final_norm = ParamGroup(enc["final_norm"], dtype,
                                               device)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Name-based initialization, the reference's rules (`init_params`):
    norm scales, q/k norms, `norm_scale` and `d_skip` ones, biases zeros,
    `a_log` log U(1, 16), `dt_bias` softplus^-1 of U(1e-3, 0.1), `tokens`
    0.02·N(0,1), everything else N(0,1)/sqrt(fan_in); drawn in float32 on
    the generator's device and cast to the weight's dtype, one weight
    after the other in module order, a weight of three or more axes (the
    experts) one slice of its leading axis at a time, so no float32 copy
    of a whole expert stack exists.  The draws are torch's, not
    `jax.random.fold_in`'s: weights equal to the reference's come in
    through `convert.params_from_numpy`."""
    def draw(shape, dev):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    for path, p in module.named_parameters():
        name = path.rsplit(".", 1)[-1]
        if name in ("scale", "q_norm", "k_norm", "norm_scale", "d_skip"):
            p.fill_(1.0)
        elif name.startswith("b"):               # bq, bk, bv, bias
            p.zero_()
        elif name == "a_log":
            p.copy_(draw(p.shape, p.device).uniform_(
                1.0, 16.0, generator=generator).log_())
        elif name == "dt_bias":                  # softplus^-1
            p.copy_(draw(p.shape, p.device).uniform_(
                1e-3, 0.1, generator=generator).expm1_().log_())
        else:
            std = 0.02 if name == "tokens" else 1.0 / math.sqrt(
                p.shape[-2] if p.dim() >= 2 else p.shape[-1])
            for part in (p if p.dim() >= 3 else (p,)):
                part.copy_(draw(part.shape, p.device).normal_(
                    generator=generator).mul_(std))


# =====================================================================
# Forward passes
# =====================================================================

def _maybe_remat(fn, cfg: ModelConfig):
    """The reference's `_maybe_remat`: with `cfg.remat` (and autograd
    recording) the layer body keeps only its inputs for the backward
    pass and recomputes the rest there.  The weights it reads are
    read again at the recompute, so the backward must run while the
    same weights are bound (`Model.bound`)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _check_rows(pos: int, S: int, t_max: int) -> None:
    """A KV write of rows [pos, pos + S) must fit the cache (the
    reference's dynamic_update_slice would clamp it onto the last
    rows)."""
    if pos < 0 or pos + S > t_max:
        raise ValueError(f"KV cache overflow: rows [{pos}, {pos + S}) "
                         f"do not fit a cache of T_max={t_max}")


def _dense_layer(x, lp: Layer, cfg: ModelConfig, *, positions,
                 cache=None, prefix_len=0):
    """A decoder layer (dense, moe, vlm), or zamba2's shared block."""
    h = L.norm(x, lp.attn_norm, cfg)
    a, kv = L.attention(h, lp.attn, cfg, q_positions=positions, cache=cache,
                        prefix_len=prefix_len)
    x = x + a
    h = L.norm(x, lp.mlp_norm, cfg)
    if cfg.family == "moe":
        return x + moe_mod.moe_block(h, lp.mlp, cfg), kv
    return x + L.mlp(h, lp.mlp, cfg), kv


def _decoder_stack(params, x, cfg: ModelConfig, *, positions, cache=None,
                   prefix_len=0):
    """Loop the layers.  cache: None or {"k", "v": (L, B, T_max, K, dh),
    "pos": int}; its rows [pos, pos + S) are written in place, and the
    returned dict (the same tensors) has pos advanced by S.  A write
    past T_max raises."""
    if cache is None:
        def body(xc, lp):
            return _dense_layer(xc, lp, cfg, positions=positions,
                                prefix_len=prefix_len)[0]
        body = _maybe_remat(body, cfg)
        for lp in params.layers:
            x = body(x, lp)
        return x, None
    S = x.shape[1]
    pos = int(cache["pos"])
    _check_rows(pos, S, cache["k"].shape[2])
    for i, lp in enumerate(params.layers):
        c = {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
        x, _ = _dense_layer(x, lp, cfg, positions=positions, cache=c,
                            prefix_len=prefix_len)
    return x, dict(cache, pos=pos + S)


def _mamba_stack(params, x, cfg: ModelConfig, *, positions, cache=None,
                 decode=False):
    """The ssm family's mamba2 layers; for hybrid (zamba2) also ONE
    shared attention block, run before layer i when i % attn_every == 0,
    with KV slot (its call's index) in cache["ak"] / cache["av"].

    cache: None, or {"conv": (L, B, kw-1, Cd), "state": (L, B, H, P, N)
    f32, ("ak", "av": (slots, B, T_max, K, dh),) "pos": int}: each
    layer's conv and state are replaced in place by the new ones, the
    shared block's K/V rows written at [pos, pos + S).  A prefill starts
    every SSM state from zeros, as the reference's does, so a prefill
    into a cache at pos != 0 raises (the reference would silently drop
    the cached state)."""
    hybrid = cfg.family == "hybrid"
    every = max(cfg.attn_every, 1)
    if cache is None:
        def body(xc, lp, attn: bool):
            if attn:
                xc, _ = _dense_layer(xc, params.shared, cfg,
                                     positions=positions)
            return xc + ssm_mod.mamba_block(L.norm(xc, lp.norm, cfg),
                                            lp.mixer, cfg)[0]
        body = _maybe_remat(body, cfg)
        for i, lp in enumerate(params.layers):
            x = body(x, lp, hybrid and i % every == 0)
        return x, None
    S = x.shape[1]
    pos = int(cache["pos"])
    if not decode and pos != 0:
        raise ValueError(
            f"{cfg.family} prefill at pos {pos}: a prefill restarts "
            "the SSM state from zeros, so it must start an empty "
            "cache (pos 0)")
    if hybrid:
        _check_rows(pos, S, cache["ak"].shape[2])
    slot = -1
    for i, lp in enumerate(params.layers):
        if hybrid and i % every == 0:
            slot += 1
            c = {"k": cache["ak"][slot], "v": cache["av"][slot], "pos": pos}
            x, _ = _dense_layer(x, params.shared, cfg, positions=positions,
                                cache=c)
        h = L.norm(x, lp.norm, cfg)
        if decode:
            y, sc = ssm_mod.mamba_decode_step(
                h, lp.mixer, cfg, {"conv": cache["conv"][i],
                                   "state": cache["state"][i]})
        else:
            y, sc = ssm_mod.mamba_block(h, lp.mixer, cfg)
        cache["conv"][i].copy_(sc["conv"])
        cache["state"][i].copy_(sc["state"])
        x = x + y
    return x, dict(cache, pos=pos + S)


def _sinusoidal(S: int, D: int, dtype, device) -> torch.Tensor:
    """The encoder's position table, in float64 numpy cast to dtype, as
    the reference builds it."""
    pos = np.arange(S)[:, None]
    dim = np.arange(D // 2)[None, :]
    ang = pos / (10_000 ** (2 * dim / D))
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.as_tensor(out, device=device).to(dtype)


def _encdec_encoder(params, enc_input, cfg: ModelConfig):
    """Whisper encoder over stub frame embeddings (bidirectional, no
    rope; a sinusoidal table added to the input)."""
    dev = params.embed["tokens"].device
    x = torch.as_tensor(enc_input, device=dev).to(DTYPES[cfg.dtype])
    B, Se = x.shape[:2]
    x = x + _sinusoidal(Se, cfg.d_model, x.dtype, dev)[None]
    positions = torch.arange(Se, device=dev)[None].expand(B, Se)
    enc = params.encoder

    def body(xc, lp):
        h = L.norm(xc, lp.attn_norm, cfg)
        a, _ = L.attention(h, lp.attn, cfg, q_positions=positions,
                           causal=False, use_rope=False)
        xc = xc + a
        h = L.norm(xc, lp.mlp_norm, cfg)
        return xc + L.mlp(h, lp.mlp, cfg)
    body = _maybe_remat(body, cfg)
    for lp in enc.layers:
        x = body(x, lp)
    return L.norm(x, enc.final_norm, cfg)


def _encdec_decoder(params, x, enc_out, cfg: ModelConfig, *, positions,
                    cache=None):
    """Whisper decoder: causal self-attention, cross-attention to the
    encoder output (or the cache's precomputed xk / xv), mlp.  It has no
    position signal at all (no rope, no sinusoid), as in the reference.
    cache: None or {"k", "v": (L, B, T_max, K, dh), "xk", "xv": (L, B,
    Se, K, dh), "pos": int}; self-attention rows written in place."""
    def layer(xc, lp, self_c=None, cross_c=None):
        h = L.norm(xc, lp.attn_norm, cfg)
        a, _ = L.attention(h, lp.attn, cfg, q_positions=positions,
                           cache=self_c, causal=True, use_rope=False)
        xc = xc + a
        h = L.norm(xc, lp.cross_norm, cfg)
        a, _ = L.attention(h, lp.cross, cfg, x_kv=enc_out,
                           q_positions=positions, cache=cross_c,
                           causal=False, use_rope=False)
        xc = xc + a
        h = L.norm(xc, lp.mlp_norm, cfg)
        return xc + L.mlp(h, lp.mlp, cfg)

    if cache is None:
        body = _maybe_remat(layer, cfg)
        for lp in params.layers:
            x = body(x, lp)
        return x, None
    S = x.shape[1]
    pos = int(cache["pos"])
    _check_rows(pos, S, cache["k"].shape[2])
    for i, lp in enumerate(params.layers):
        x = layer(x, lp, {"k": cache["k"][i], "v": cache["v"][i],
                          "pos": pos},
                  {"xk": cache["xk"][i], "xv": cache["xv"][i]})
    return x, dict(cache, pos=pos + S)


def _cross_kv(params, enc_out, cfg: ModelConfig) -> dict:
    """Each decoder layer's cross K / V of the encoder output (no bias,
    as in the reference): {"xk", "xv": (L, B, Se, K, dh)}."""
    K, dh = cfg.n_kv_heads, cfg.head_dim
    B, Se = enc_out.shape[:2]
    ks, vs = [], []
    for lp in params.layers:
        ks.append((enc_out @ lp.cross["wk"].to(enc_out.dtype))
                  .reshape(B, Se, K, dh))
        vs.append((enc_out @ lp.cross["wv"].to(enc_out.dtype))
                  .reshape(B, Se, K, dh))
    return {"xk": torch.stack(ks), "xv": torch.stack(vs)}


def _stack(params, x, batch, cfg: ModelConfig, *, positions, cache=None,
           prefix_len=0, decode=False):
    """The family's layer stack -> (x, cache).  encdec: at prefill the
    encoder runs and the cache's xk / xv are replaced by its cross K / V;
    at decode the cache supplies them."""
    if cfg.family in DECODER_FAMILIES:
        return _decoder_stack(params, x, cfg, positions=positions,
                              cache=cache, prefix_len=prefix_len)
    if cfg.family in ("ssm", "hybrid"):
        return _mamba_stack(params, x, cfg, positions=positions,
                            cache=cache, decode=decode)
    if cfg.family == "encdec":
        enc_out = None
        if not decode:
            enc_out = _encdec_encoder(params, batch["enc_input"], cfg)
            if cache is not None:
                cache = dict(cache, **_cross_kv(params, enc_out, cfg))
        return _encdec_decoder(params, x, enc_out, cfg, positions=positions,
                               cache=cache)
    raise ValueError(cfg.family)


def _logits(params, x, cfg: ModelConfig):
    unembed = params.unembed
    return L.unembed(x, params.embed["tokens"],
                     None if unembed is None else unembed["kernel"], cfg)


def _inputs(params, batch, cfg: ModelConfig):
    """Embedded tokens (the VLM's vision prefix prepended), positions,
    prefix length."""
    dev = params.embed["tokens"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = L.embed(tokens, params.embed["tokens"]).to(DTYPES[cfg.dtype])
    prefix_len = 0
    if cfg.family == "vlm":
        vis = torch.as_tensor(batch["vision"], device=dev).to(x.dtype)
        x = torch.cat([vis, x], dim=1)
        prefix_len = vis.shape[1]
    B, S = x.shape[:2]
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    return x, positions, prefix_len


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence forward -> logits (B, S_text, V)."""
    x, positions, prefix_len = _inputs(params, batch, cfg)
    x, _ = _stack(params, x, batch, cfg, positions=positions,
                  prefix_len=prefix_len)
    x = L.norm(x, params.final_norm, cfg)
    if cfg.family == "vlm":
        x = x[:, prefix_len:]                        # logits on text only
    return _logits(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    """Next-token cross entropy (labels = batch["labels"], < 0 masked):
    float32 logits, logsumexp minus the gold logit, summed over the
    unmasked positions and divided by max(their count, 1)."""
    logits = forward(params, batch, cfg).float()
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    mask = (labels >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def prefill(params, batch, cache, cfg: ModelConfig):
    """Run the prompt through the model, filling `cache` from its pos.
    Returns (last-position logits (B, V), cache)."""
    x, positions, prefix_len = _inputs(params, batch, cfg)
    x, cache = _stack(params, x, batch, cfg, positions=positions,
                      cache=cache, prefix_len=prefix_len)
    x = L.norm(x[:, -1:], params.final_norm, cfg)
    return _logits(params, x, cfg)[:, 0], cache


def decode_step(params, token, cache, cfg: ModelConfig):
    """One decode step.  token: (B, 1) integer.  Returns (logits (B, V),
    cache)."""
    dev = params.embed["tokens"].device
    token = torch.as_tensor(token, device=dev)
    x = L.embed(token, params.embed["tokens"]).to(DTYPES[cfg.dtype])
    B = x.shape[0]
    positions = torch.full((B, 1), int(cache["pos"]), dtype=torch.int32,
                           device=dev)
    x, cache = _stack(params, x, None, cfg, positions=positions,
                      cache=cache, decode=True)
    x = L.norm(x, params.final_norm, cfg)
    return _logits(params, x, cfg)[:, 0], cache
