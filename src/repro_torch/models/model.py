"""Public model API, the counterpart of `repro.models.model`: `Model`
holds its weights as an `nn.Module` on an explicit device, plus the
batch and cache builders used by the server.

The reference's `Model` is a stateless facade whose methods take the
parameter tree; the port's holds the weights itself, so its methods
take only the batch and the cache.  Weights equal to a reference tree
come in through `convert.params_from_numpy` and `load_state_dict`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from ..device import resolve_device
from ..sharding.rules import ParamMeta
from . import transformer as T
from .config import ModelConfig, ShapeConfig

__all__ = ["Model", "batch_metas", "concrete_batch", "cache_metas"]


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

def cache_metas(cfg: ModelConfig, B: int, T_max: int) -> dict:
    """The dense KV cache: k, v (L, B, T_max, K, dh) and the write
    position."""
    T.check_family(cfg)
    K, dh, Ls = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    kv_axes = (None, "cache_batch", "cache_seq", None, None)
    return {"pos": ParamMeta((), (), "int32"),
            "k": ParamMeta((Ls, B, T_max, K, dh), kv_axes, cfg.dtype),
            "v": ParamMeta((Ls, B, T_max, K, dh), kv_axes, cfg.dtype)}


# ------------------------------------------------------------------ model

class Model(nn.Module):
    """A decoder LM of the dense or VLM family on one device.

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
        def count(tree: Any) -> int:
            if isinstance(tree, ParamMeta):
                return math.prod(tree.shape)
            return sum(count(v) for v in tree.values())
        return count(self.param_metas())

    # compute
    @torch.inference_mode()
    def forward(self, batch: dict) -> torch.Tensor:
        return T.forward(self, batch, self.cfg)

    def init_cache(self, B: int, T_max: int) -> dict:
        metas = cache_metas(self.cfg, B, T_max)
        return {"pos": 0,
                **{name: torch.zeros(metas[name].shape, dtype=self.dtype,
                                     device=self.device)
                   for name in ("k", "v")}}

    @torch.inference_mode()
    def prefill(self, batch: dict, cache: dict):
        return T.prefill(self, batch, cache, self.cfg)

    @torch.inference_mode()
    def decode_step(self, token, cache: dict):
        return T.decode_step(self, token, cache, self.cfg)
