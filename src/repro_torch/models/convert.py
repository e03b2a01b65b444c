"""Weights between the reference's parameter tree and the port's modules.

The reference holds a nested dict whose layer weights carry a leading L
axis (`repro.models.transformer.param_metas`); the port holds one
`Layer` a layer.  `params_from_numpy` takes that tree as numpy arrays
(`jax.tree.map(np.asarray, params)`) and returns the port's
`state_dict`: the L axis split into `layers.<i>.` (n_layers) and
`encoder.layers.<i>.` (n_enc_layers), every other leaf (`shared.*`,
`encoder.final_norm.*`, ...) at its dotted path.  The fused 2-D
projections keep their orientation ((d_model, heads*d_head) and back:
`x @ w` in both packages), so no weight is transposed.
`params_to_numpy` is the inverse; the round trip is bit for bit,
bfloat16 included (numpy's bfloat16 is ml_dtypes').

Training keeps its tensors in the reference's layout: `stack_params`
turns a `state_dict` into {dotted reference path: (L, ...) tensor}, and
`unstack_params` gives the model one view a layer back (`unbind`, whose
backward stacks the layers' gradients into one tensor); `nest` /
`flatten` move between dotted paths and the reference's nested tree.
Only `params_to_numpy` needs ml_dtypes (for a bfloat16 weight); nothing
that runs on the card calls it (the checkpoint writes bfloat16 through
its int16 bits).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .transformer import param_metas

__all__ = ["params_from_numpy", "params_to_numpy", "stack_params",
           "unstack_params", "nest", "flatten"]


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _leaves(tree: dict, prefix: str = ""):
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", v


def flatten(tree: dict) -> dict:
    """A nested dict -> {dotted path: leaf}, in the tree's order."""
    return dict(_leaves(tree))


def nest(flat: dict) -> dict:
    """{dotted path: leaf} -> the nested dict (the inverse of
    `flatten`)."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _stack_of(cfg: ModelConfig, path: str):
    """(prefix, depth) of the stacked layers a leaf belongs to, or
    None for an unstacked leaf."""
    for prefix, depth in (("encoder.layers.", cfg.n_enc_layers),
                          ("layers.", cfg.n_layers)):
        if path.startswith(prefix):
            return prefix, depth
    return None


def params_from_numpy(cfg: ModelConfig, tree: dict) -> dict:
    """The reference's parameter tree (numpy leaves) -> the port's
    `state_dict` for `Model(cfg)`.  Every leaf's shape is checked
    against `param_metas(cfg)`."""
    metas = flatten(param_metas(cfg))
    got = flatten(tree)
    if set(got) != set(metas):
        raise ValueError(f"parameter tree differs from {cfg.name}'s metas: "
                         f"missing {sorted(set(metas) - set(got))}, "
                         f"extra {sorted(set(got) - set(metas))}")
    for path, a in got.items():
        if np.shape(a) != metas[path].shape:
            raise ValueError(f"{path}: shape {np.shape(a)}, metas say "
                             f"{metas[path].shape}")
    return unstack_params(cfg, {path: _to_torch(np.asarray(a))
                                for path, a in got.items()})


def stack_params(cfg: ModelConfig, sd: dict) -> dict:
    """A `state_dict` (or gradients keyed like it) -> {dotted reference
    path: tensor}, layer weights stacked on a leading L axis (a copy),
    in `param_metas` order."""
    out = {}
    for path in flatten(param_metas(cfg)):
        stack = _stack_of(cfg, path)
        if stack is not None:
            prefix, depth = stack
            rest = path[len(prefix):]
            out[path] = torch.stack([sd[f"{prefix}{i}.{rest}"]
                                     for i in range(depth)])
        else:
            out[path] = sd[path]
    return out


def unstack_params(cfg: ModelConfig, params: dict) -> dict:
    """{dotted reference path: tensor} -> the `state_dict` names, a
    stacked tensor split into one view a layer by `unbind`."""
    out = {}
    for path, t in params.items():
        stack = _stack_of(cfg, path)
        if stack is not None:
            prefix, _ = stack
            rest = path[len(prefix):]
            for i, ti in enumerate(t.unbind(0)):
                out[f"{prefix}{i}.{rest}"] = ti
        else:
            out[path] = t
    return out


def params_to_numpy(model) -> dict:
    """The port's weights as the reference's tree (numpy leaves, layer
    weights stacked on a leading L axis)."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return nest({path: _to_numpy(t)
                 for path, t in stack_params(model.cfg, sd).items()})
