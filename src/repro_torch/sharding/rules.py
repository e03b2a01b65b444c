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

Resolution against a mesh (`resolve_spec`, `param_pspecs`) gives
`PartitionSpec`s as data: a mesh is axis names and sizes over logical
devices (`launch.mesh.Mesh`; anything with a `shape` dict will do).
`shard` places a tensor by its spec (one block a logical device);
`constrain` only checks its spec, because the layers place no
activation on one card (the reference's is the identity without a
mesh too).

  * parameters / inputs — strict: an axis is used only if the dimension
    divides the mesh-axes product; otherwise the dimension is
    replicated.
  * activations — permissive: uneven sharding is allowed, but a mesh
    axis is never used twice within one tensor and tiny dims (dim <
    shards) fall back to replication.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = [
    "AxisRules", "ParamMeta", "TRAIN_RULES", "SERVE_RULES",
    "LONG_DECODE_RULES", "PURE_DP_TRAIN_RULES", "PartitionSpec",
    "resolve_spec", "constrain", "param_pspecs", "abstract_params", "shard",
]


class PartitionSpec(tuple):
    """Per tensor dimension: None (replicated), a mesh axis name, or a
    tuple of names — `jax.sharding.PartitionSpec` as a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


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


# ------------------------------------------------------------ resolution

def _mesh_size(mesh, axes: tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def resolve_spec(mesh, rules: AxisRules, axes: tuple[str | None, ...],
                 shape: tuple[int, ...], *, strict: bool) -> PartitionSpec:
    """Map logical axes -> PartitionSpec under the rule table.

    If the full mesh-axis tuple does not fit a dimension, suffixes are
    tried (batch 256 on ('pod','data','model') = 512 falls back to
    ('data','model') = 256), so one table serves both the single-pod
    and the multi-pod mesh."""
    used: set[str] = set()
    out: list[Any] = []
    for dim, logical in zip(shape, axes):
        cand = [a for a in rules.get(logical)
                if a in mesh.shape and a not in used]
        placed = False
        while cand:
            size = _mesh_size(mesh, tuple(cand))
            ok = (dim % size == 0) if strict else (dim >= size)
            if ok:
                used.update(cand)
                out.append(tuple(cand) if len(cand) > 1 else cand[0])
                placed = True
                break
            cand = cand[1:]             # drop the leading (outermost) axis
        if not placed:
            out.append(None)
    return PartitionSpec(*out)


def constrain(x, mesh, rules: AxisRules, *axes: str | None):
    """The reference's sharding constraint by logical names (permissive
    resolution).  Nothing places an activation here: the spec is
    resolved, which checks the names against x's rank, and x comes back
    as it was."""
    if mesh is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"{len(axes)} logical axes for a tensor of rank "
                         f"{x.dim()}")
    resolve_spec(mesh, rules, tuple(axes), tuple(x.shape), strict=False)
    return x


def _map_metas(fn, metas):
    if isinstance(metas, ParamMeta):
        return fn(metas)
    return {k: _map_metas(fn, v) for k, v in metas.items()}


def param_pspecs(metas, mesh, rules: AxisRules):
    """Nested dict of ParamMeta -> the same of PartitionSpec (strict)."""
    return _map_metas(
        lambda m: resolve_spec(mesh, rules, m.axes, m.shape, strict=True),
        metas)


def abstract_params(metas):
    """Nested dict of ParamMeta -> `meta` tensors (shape and dtype, no
    storage): the dry-run stand-ins."""
    return _map_metas(
        lambda m: torch.empty(m.shape, dtype=getattr(torch, m.dtype),
                              device="meta"), metas)


def shard(x: torch.Tensor, mesh, spec) -> list[torch.Tensor]:
    """Place x by `spec` over `mesh` (a `launch.mesh.Mesh`): one block a
    logical device, in device order, each on its device.  A dimension
    named by mesh axes is cut into as many equal blocks as those axes
    hold devices, the device's coordinates on them (in the spec's order)
    picking its block; it must divide evenly, as the reference's input
    shardings must."""
    parts = tuple(spec) + (None,) * (x.dim() - len(spec))
    if len(parts) != x.dim():
        raise ValueError(f"spec {spec} has more entries than x's rank "
                         f"{x.dim()}")
    named = [a for p in parts if p for a in ((p,) if isinstance(p, str)
                                              else p)]
    if len(set(named)) != len(named) or not set(named) <= set(mesh.shape):
        raise ValueError(f"spec {spec} over mesh axes {mesh.shape}")
    out = []
    for i, dev in enumerate(mesh.devices):
        coord = mesh.coords(i)
        block = x
        for dim, p in enumerate(parts):
            if not p:
                continue
            names = (p,) if isinstance(p, str) else p
            n = _mesh_size(mesh, names)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {names} ({n})")
            idx = 0
            for a in names:
                idx = idx * mesh.shape[a] + coord[a]
            size = x.shape[dim] // n
            block = block.narrow(dim, idx * size, size)
        out.append(block.to(dev))
    return out
