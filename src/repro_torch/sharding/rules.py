"""Logical-axis sharding rules (MaxText-style), the data half of
`repro.sharding.rules`.

Tensors carry *logical* axis names; a rule table maps each name to the
mesh axes it may shard over.  The port keeps the parameter metadata
(`ParamMeta`: shape, logical axes, dtype) that drives the models'
shapes and initialization, and the rule tables as data:

  TRAIN_RULES        — DP over (pod, data), TP over model, FSDP(ZeRO-3)
                       weight sharding over data for `fsdp=True` archs.
  SERVE_RULES        — decode: batch over (pod, data); KV-cache *sequence*
                       over model (flash-decode style).
  LONG_DECODE_RULES  — batch=1 long-context: sequence/state sharded over
                       both data and model.

Resolving a table against a device mesh (`resolve_spec`, `param_pspecs`,
`constrain`) is not ported yet: on one card the layers place nothing,
as the reference's `constrain` does nothing without a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = [
    "AxisRules", "ParamMeta", "TRAIN_RULES", "SERVE_RULES",
    "LONG_DECODE_RULES", "PURE_DP_TRAIN_RULES",
]


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    """Shape + logical axes + dtype for one parameter tensor."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: Any = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


@dataclasses.dataclass(frozen=True)
class AxisRules:
    table: dict[str, tuple[str, ...]]

    def get(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        return self.table.get(logical, ())


# --------------------------------------------------------------- tables

def _t(**kw) -> AxisRules:
    return AxisRules({k: (v,) if isinstance(v, str) else tuple(v)
                      for k, v in kw.items() if v is not None})


TRAIN_RULES = _t(
    # parameters
    vocab="model", heads="model", kv="model", ff="model", expert="model",
    ssm_inner="model", conv_dim="model",
    embed_fsdp=("pod", "data"),     # only emitted when cfg.fsdp
    # activations
    act_batch=("pod", "data"), act_heads="model", act_ff="model",
    act_vocab="model", act_expert="model", act_ssm="model",
)

SERVE_RULES = _t(
    vocab="model", heads="model", kv="model", ff="model", expert="model",
    ssm_inner="model", conv_dim="model",
    embed_fsdp=("pod", "data"),
    act_batch=("pod", "data"), act_heads="model", act_ff="model",
    act_vocab="model", act_expert="model", act_ssm="model",
    cache_batch=("pod", "data"),
    cache_seq="model",              # flash-decode: shard KV sequence
)

PURE_DP_TRAIN_RULES = _t(
    act_batch=("pod", "data", "model"),
)

LONG_DECODE_RULES = _t(
    vocab="model", heads="model", kv="model", ff="model", expert="model",
    ssm_inner="model", conv_dim="model",
    embed_fsdp=("pod", "data"),
    act_heads="model", act_ff="model", act_vocab="model", act_ssm="model",
    cache_seq=("data", "model"),    # batch=1: all parallelism into sequence
    state_heads="model",            # SSM decode state heads
)
