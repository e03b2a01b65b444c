"""Public model API, the counterpart of `repro.models.model`: `Model`
holds its weights as an `nn.Module` on an explicit device, plus the
batch and cache builders used by the server.

The reference's `Model` is a stateless facade whose methods take the
parameter tree; the port's holds the weights itself, so its methods
take only the batch and the cache.  Weights equal to a reference tree
come in through `convert.params_from_numpy` and `load_state_dict`.
Serving (`forward`, `prefill`, `decode_step`) runs under
`torch.inference_mode`; `loss` records autograd, and `bound` lends the
model other weights (a train state's) for a forward and its backward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
from torch import nn

from ..device import resolve_device
from ..sharding.rules import ParamMeta
from . import transformer as T
from .config import ModelConfig, ShapeConfig

__all__ = ["Model", "batch_metas", "concrete_batch", "cache_metas",
           "n_params", "n_active_params"]


# ------------------------------------------------------------ batch metas

def batch_metas(cfg: ModelConfig, sc: ShapeConfig) -> dict[str, ParamMeta]:
    """Input tensors for one step of the given shape cell."""
    B, S = sc.global_batch, sc.seq_len
    out: dict[str, ParamMeta] = {}
    if sc.kind == "train":
        s_text = S - (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
        out["tokens"] = ParamMeta((B, s_text), ("act_batch", None), "int32")
        out["labels"] = ParamMeta((B, s_text), ("act_batch", None), "int32")
    elif sc.kind == "prefill":
        s_text = S - (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
        out["tokens"] = ParamMeta((B, s_text), ("act_batch", None), "int32")
    else:                                    # decode: one new token
        out["tokens"] = ParamMeta((B, 1), ("act_batch", None), "int32")
    if cfg.family == "vlm" and sc.kind != "decode":
        out["vision"] = ParamMeta((B, cfg.n_vision_tokens, cfg.d_model),
                                  ("act_batch", None, None), cfg.dtype)
    if cfg.family == "encdec" and sc.kind != "decode":
        out["enc_input"] = ParamMeta((B, cfg.enc_seq_len, cfg.d_model),
                                     ("act_batch", None, None), cfg.dtype)
    return out


def concrete_batch(cfg: ModelConfig, sc: ShapeConfig,
                   generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A random batch on the generator's device: token ids uniform over
    the vocabulary, float inputs N(0,1) cast to their dtype.  The draws
    are torch's, not `jax.random`'s."""
    dev = generator.device
    out = {}
    for name, m in batch_metas(cfg, sc).items():
        if m.dtype == "int32":
            out[name] = torch.randint(0, cfg.vocab_size, m.shape,
                                      generator=generator, device=dev,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(m.shape, generator=generator,
                                    device=dev).to(T.DTYPES[m.dtype])
    return out


# ------------------------------------------------------------ cache metas

def cache_metas(cfg: ModelConfig, B: int, T_max: int,
                enc_len: int | None = None) -> dict:
    """Every family's cache: k, v (L, B, T_max, K, dh) for the decoder
    families and encdec; xk, xv (L, B, Se, K, dh) for encdec's cross
    attention (Se = enc_len or cfg.enc_seq_len); conv (L, B, kw-1, Cd)
    and the float32 state (L, B, H, P, N) for ssm and hybrid; ak, av
    (slots, B, T_max, K, dh) for hybrid, one slot a shared-block call;
    and the write position."""
    dt = cfg.dtype
    K, dh, Ls = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    kv_axes = (None, "cache_batch", "cache_seq", None, None)
    out: dict[str, Any] = {"pos": ParamMeta((), (), "int32")}
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        out["k"] = ParamMeta((Ls, B, T_max, K, dh), kv_axes, dt)
        out["v"] = ParamMeta((Ls, B, T_max, K, dh), kv_axes, dt)
    if cfg.family == "encdec":
        Se = enc_len or cfg.enc_seq_len
        xa = (None, "cache_batch", None, None, None)
        out["xk"] = ParamMeta((Ls, B, Se, K, dh), xa, dt)
        out["xv"] = ParamMeta((Ls, B, Se, K, dh), xa, dt)
    if cfg.family in ("ssm", "hybrid"):
        conv_d = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        out["conv"] = ParamMeta((Ls, B, cfg.ssm_conv - 1, conv_d),
                                (None, "cache_batch", None, "conv_dim"), dt)
        out["state"] = ParamMeta(
            (Ls, B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            (None, "cache_batch", "state_heads", None, None), "float32")
    if cfg.family == "hybrid":
        every = max(cfg.attn_every, 1)
        n_slots = sum(i % every == 0 for i in range(Ls))
        out["ak"] = ParamMeta((n_slots, B, T_max, K, dh), kv_axes, dt)
        out["av"] = ParamMeta((n_slots, B, T_max, K, dh), kv_axes, dt)
    return out


# ------------------------------------------------------------ param counts

def _meta_leaves(tree: dict, path: tuple = ()):
    for name, v in tree.items():
        if isinstance(v, ParamMeta):
            yield path + (name,), v
        else:
            yield from _meta_leaves(v, path + (name,))


def n_params(cfg: ModelConfig) -> int:
    """Parameters of the model, from the metas alone (no weight is
    allocated): the reference's `Model.n_params`."""
    return sum(math.prod(m.shape) for _, m in _meta_leaves(T.param_metas(cfg)))


def n_active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token, from the metas alone (no weight is
    allocated): for moe the expert stacks count k of their E experts;
    every other family touches all of its parameters."""
    total = 0
    for path, m in _meta_leaves(T.param_metas(cfg)):
        size = math.prod(m.shape)
        if (cfg.family == "moe" and "mlp" in path and len(m.shape) == 4
                and path[-1] in ("wg", "wu", "wo")):
            size = size * cfg.experts_per_token // cfg.n_experts
        total += size
    return total


# ------------------------------------------------------------------ model

class Model(nn.Module):
    """An LM of any family on one device.

    `device=None` means the card (`resolve_device`); `dtype` (a torch
    dtype or its name) overrides `cfg.dtype`, which sets the weights',
    activations' and cache's dtype.  The weights are drawn from
    `torch.Generator(device).manual_seed(seed)` by the reference's
    name-based rules (`transformer.init_params`); `seed=None` leaves
    them uninitialized, for a `load_state_dict` to fill.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None,
                 seed: int | None = 0):
        super().__init__()
        if dtype is not None:
            name = dtype if isinstance(dtype, str) else {
                v: k for k, v in T.DTYPES.items()}[dtype]
            cfg = dataclasses.replace(cfg, dtype=name)
        self.cfg = cfg
        self.device = resolve_device(device)
        T.make_params(self, cfg, self.device)
        if seed is not None:
            T.init_params(self, torch.Generator(
                device=self.device).manual_seed(seed))

    @property
    def dtype(self) -> torch.dtype:
        return T.DTYPES[self.cfg.dtype]

    # params
    def param_metas(self) -> dict:
        return T.param_metas(self.cfg)

    def n_params(self) -> int:
        """Parameters held by this module (the reference counts its
        metas; `n_meta_params` does so here)."""
        return sum(p.numel() for p in self.parameters())

    def n_meta_params(self) -> int:
        return n_params(self.cfg)

    def n_active_params(self) -> int:
        """MoE: parameters touched per token (top-k of E experts)."""
        return n_active_params(self.cfg)

    # compute
    @torch.inference_mode()
    def forward(self, batch: dict) -> torch.Tensor:
        return T.forward(self, batch, self.cfg)

    def loss(self, batch: dict) -> torch.Tensor:
        """The reference's `Model.loss`: next-token cross entropy of the
        weights in use (the model's own, or those `bound` lends it),
        recorded for autograd where they require grad."""
        return T.loss_fn(self, batch, self.cfg)

    @contextlib.contextmanager
    def bound(self, params: dict):
        """Compute with `params` (state_dict names -> tensors of the
        same shapes) in place of the model's weights while the context
        is open.  With `cfg.remat` the backward pass reads the weights
        again, so it must run inside the same context."""
        saved = []
        try:
            for name, t in params.items():
                path, _, attr = name.rpartition(".")
                group = self.get_submodule(path)
                old = group._parameters[attr]
                if t.shape != old.shape:
                    raise ValueError(f"{name}: shape {tuple(t.shape)}, the "
                                     f"model's is {tuple(old.shape)}")
                saved.append((group, attr, old))
                group._parameters[attr] = t
            yield self
        finally:
            for group, attr, old in reversed(saved):
                group._parameters[attr] = old

    def init_cache(self, B: int, T_max: int,
                   enc_len: int | None = None) -> dict:
        """Zeros in each entry's meta dtype (the state float32, the rest
        the model's), on the model's device; pos 0."""
        return {name: 0 if name == "pos" else torch.zeros(
                    m.shape, dtype=T.DTYPES[m.dtype], device=self.device)
                for name, m in cache_metas(self.cfg, B, T_max,
                                           enc_len).items()}

    @torch.inference_mode()
    def prefill(self, batch: dict, cache: dict):
        return T.prefill(self, batch, cache, self.cfg)

    @torch.inference_mode()
    def decode_step(self, token, cache: dict):
        return T.decode_step(self, token, cache, self.cfg)
