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
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .transformer import param_metas

__all__ = ["params_from_numpy", "params_to_numpy"]


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
    metas = dict(_leaves(param_metas(cfg)))
    got = dict(_leaves(tree))
    if set(got) != set(metas):
        raise ValueError(f"parameter tree differs from {cfg.name}'s metas: "
                         f"missing {sorted(set(metas) - set(got))}, "
                         f"extra {sorted(set(got) - set(metas))}")
    out = {}
    for path, a in got.items():
        a = np.asarray(a)
        if a.shape != metas[path].shape:
            raise ValueError(f"{path}: shape {a.shape}, metas say "
                             f"{metas[path].shape}")
        stack = _stack_of(cfg, path)
        if stack is not None:
            prefix, depth = stack
            rest = path[len(prefix):]
            for i in range(depth):
                out[f"{prefix}{i}.{rest}"] = _to_torch(a[i])
        else:
            out[path] = _to_torch(a)
    return out


def params_to_numpy(model) -> dict:
    """The port's weights as the reference's tree (numpy leaves, layer
    weights stacked on a leading L axis)."""
    cfg = model.cfg
    sd = model.state_dict()
    tree: dict = {}
    for path, _ in _leaves(param_metas(cfg)):
        stack = _stack_of(cfg, path)
        if stack is not None:
            prefix, depth = stack
            rest = path[len(prefix):]
            a = np.stack([_to_numpy(sd[f"{prefix}{i}.{rest}"])
                          for i in range(depth)])
        else:
            a = _to_numpy(sd[path])
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree
