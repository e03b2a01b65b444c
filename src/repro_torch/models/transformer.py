"""Family assembly of the dense and VLM families: parameter metas, the
module tree that holds the weights, name-based initialization, and
forward / prefill / decode — the counterpart of
`repro.models.transformer`.

The reference stacks each layer weight on a leading L axis and scans
over it; the port holds one `DenseLayer` module a layer in an
`nn.ModuleList` and loops.  `param_metas` keeps the reference's stacked
shapes (the single source of truth for both), and `convert.py` moves
weights between the two layouts.

The families moe (grok-1, kimi-k2), ssm (mamba2), hybrid (zamba2) and
encdec (whisper) are not ported yet (ROADMAP Queue 1 item 9): building
one raises NotImplementedError.  Training (`loss_fn`, remat) waits for
the training slice.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from ..sharding.rules import ParamMeta
from . import layers as L
from .config import ModelConfig

__all__ = ["PORTED_FAMILIES", "DTYPES", "check_family", "param_metas",
           "ParamGroup", "DenseLayer", "make_params", "init_params",
           "forward", "prefill", "decode_step"]

PORTED_FAMILIES = ("dense", "vlm")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            "repro_torch yet (ROADMAP Queue 1 item 9); ported: "
            f"{', '.join(PORTED_FAMILIES)}")


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


def _norm_metas(cfg: ModelConfig, stack: int | None, dt: str) -> dict:
    pm = _pm(stack, dt)
    out = {"scale": pm((cfg.d_model,), (None,))}
    if cfg.norm_type == "layernorm":
        out["bias"] = pm((cfg.d_model,), (None,))
    return out


def param_metas(cfg: ModelConfig) -> dict:
    check_family(cfg)
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
    metas["layers"] = {
        "attn_norm": _norm_metas(cfg, Ls, dt),
        "attn": _attn_metas(cfg, Ls, dt),
        "mlp_norm": _norm_metas(cfg, Ls, dt),
        "mlp": _mlp_metas(cfg, Ls, dt),
    }
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


class DenseLayer(nn.Module):
    """One decoder layer's weights (the reference's `layers` subtree at
    one index of its L axis)."""

    def __init__(self, metas: dict, dtype, device):
        super().__init__()
        for name in ("attn_norm", "attn", "mlp_norm", "mlp"):
            self.add_module(name, ParamGroup(metas[name], dtype, device,
                                             stacked=True))


def make_params(module: nn.Module, cfg: ModelConfig, device) -> None:
    """Register the weights of `cfg` on `module` (uninitialized):
    `embed`, `final_norm`, `unembed` (untied only) and `layers`."""
    metas = param_metas(cfg)
    dtype = DTYPES[cfg.dtype]
    module.embed = ParamGroup(metas["embed"], dtype, device)
    module.final_norm = ParamGroup(metas["final_norm"], dtype, device)
    module.unembed = (ParamGroup(metas["unembed"], dtype, device)
                      if "unembed" in metas else None)
    module.layers = nn.ModuleList(
        DenseLayer(metas["layers"], dtype, device)
        for _ in range(cfg.n_layers))


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Name-based initialization, the reference's rules (`init_params`):
    norm scales and q/k norms ones, biases zeros, `tokens` 0.02·N(0,1),
    everything else N(0,1)/sqrt(fan_in); drawn in float32 on the
    generator's device and cast to the weight's dtype, one weight after
    the other in module order.  The draws are torch's, not
    `jax.random.fold_in`'s: weights equal to the reference's come in
    through `convert.params_from_numpy`."""
    for path, p in module.named_parameters():
        name = path.rsplit(".", 1)[-1]
        if name in ("scale", "q_norm", "k_norm"):
            p.fill_(1.0)
        elif name.startswith("b"):               # bq, bk, bv, bias
            p.zero_()
        else:
            std = 0.02 if name == "tokens" else 1.0 / math.sqrt(
                p.shape[-2] if p.dim() >= 2 else p.shape[-1])
            w = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32, device=p.device)
            p.copy_(w.mul_(std))


# =====================================================================
# Forward passes
# =====================================================================

def _dense_layer(x, lp: DenseLayer, cfg: ModelConfig, *, positions,
                 cache=None, prefix_len=0):
    h = L.norm(x, lp.attn_norm, cfg)
    a, kv = L.attention(h, lp.attn, cfg, q_positions=positions, cache=cache,
                        prefix_len=prefix_len)
    x = x + a
    h = L.norm(x, lp.mlp_norm, cfg)
    return x + L.mlp(h, lp.mlp, cfg), kv


def _decoder_stack(params, x, cfg: ModelConfig, *, positions, cache=None,
                   prefix_len=0):
    """Loop the layers.  cache: None or {"k", "v": (L, B, T_max, K, dh),
    "pos": int}; its rows [pos, pos + S) are written in place, and the
    returned dict (the same tensors) has pos advanced by S.  A write
    past T_max raises (the reference's dynamic_update_slice would clamp
    it onto the last rows)."""
    S = x.shape[1]
    if cache is not None:
        pos, t_max = int(cache["pos"]), cache["k"].shape[2]
        if pos < 0 or pos + S > t_max:
            raise ValueError(f"KV cache overflow: rows [{pos}, {pos + S}) "
                             f"do not fit a cache of T_max={t_max}")
    for i, lp in enumerate(params.layers):
        c = None if cache is None else {"k": cache["k"][i],
                                        "v": cache["v"][i], "pos": pos}
        x, _ = _dense_layer(x, lp, cfg, positions=positions, cache=c,
                            prefix_len=prefix_len)
    if cache is None:
        return x, None
    return x, dict(cache, pos=pos + S)


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
    check_family(cfg)
    x, positions, prefix_len = _inputs(params, batch, cfg)
    x, _ = _decoder_stack(params, x, cfg, positions=positions,
                          prefix_len=prefix_len)
    x = L.norm(x, params.final_norm, cfg)
    if cfg.family == "vlm":
        x = x[:, prefix_len:]                        # logits on text only
    return _logits(params, x, cfg)


def prefill(params, batch, cache, cfg: ModelConfig):
    """Run the prompt through the model, filling `cache` from its pos.
    Returns (last-position logits (B, V), cache)."""
    check_family(cfg)
    x, positions, prefix_len = _inputs(params, batch, cfg)
    x, cache = _decoder_stack(params, x, cfg, positions=positions,
                              cache=cache, prefix_len=prefix_len)
    x = L.norm(x[:, -1:], params.final_norm, cfg)
    return _logits(params, x, cfg)[:, 0], cache


def decode_step(params, token, cache, cfg: ModelConfig):
    """One decode step.  token: (B, 1) integer.  Returns (logits (B, V),
    cache)."""
    check_family(cfg)
    dev = params.embed["tokens"].device
    token = torch.as_tensor(token, device=dev)
    x = L.embed(token, params.embed["tokens"]).to(DTYPES[cfg.dtype])
    B = x.shape[0]
    positions = torch.full((B, 1), int(cache["pos"]), dtype=torch.int32,
                           device=dev)
    x, cache = _decoder_stack(params, x, cfg, positions=positions,
                              cache=cache)
    x = L.norm(x, params.final_norm, cfg)
    return _logits(params, x, cfg)[:, 0], cache
