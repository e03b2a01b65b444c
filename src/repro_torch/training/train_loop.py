"""Train-step builder, the counterpart of `repro.training.train_loop`:
microbatch gradient accumulation, global-norm clip, optimizer update,
metrics.

A train state is {"params", "opt", "step"}: "params" the model's
weights in the reference's layout ({dotted path: tensor}, layer weights
stacked on a leading L axis; `models.convert.stack_params`), "opt" the
optimizer's state keyed the same way, "step" an int.  A step returns a
new state and never writes the one it was given, as the reference's
jitted step does without donation.  The model computes with the
state's weights through `Model.bound` (one `unbind` view a layer), so
autograd hands back each gradient already stacked.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..models import convert
from ..models.model import Model
from ..sharding.rules import PartitionSpec, abstract_params, param_pspecs
from . import optimizer as opt_mod

__all__ = ["TrainConfig", "build_train_step", "init_train_state",
           "abstract_train_state", "train_state_pspecs", "loss_and_grads",
           "state_tree", "state_from_tree"]


@dataclasses.dataclass
class TrainConfig:
    n_microbatches: int = 1
    opt: opt_mod.OptConfig = dataclasses.field(
        default_factory=opt_mod.OptConfig)


def init_train_state(model: Model, opt_cfg: opt_mod.OptConfig) -> dict:
    """The model's weights, stacked, and a fresh optimizer state, on the
    model's device; step 0.  The model's layer weights become views of
    the stacked ones (one copy of the weights, not two; no step writes
    a state in place), and from here on they require grad, so
    `Model.loss` records autograd."""
    cfg = model.cfg
    params = convert.stack_params(
        cfg, {k: p.detach() for k, p in model.named_parameters()})
    with torch.no_grad():
        for name, view in convert.unstack_params(cfg, params).items():
            path, _, attr = name.rpartition(".")
            model.get_submodule(path)._parameters[attr] = nn.Parameter(view)
    model.requires_grad_(True)
    return {"params": params,
            "opt": opt_mod.make_optimizer(opt_cfg).init(params), "step": 0}


def abstract_train_state(model: Model, opt_cfg: opt_mod.OptConfig) -> dict:
    """The train state's shapes and dtypes as `meta` tensors (no
    storage)."""
    params = convert.flatten(abstract_params(model.param_metas()))
    return {"params": params,
            "opt": opt_mod.make_optimizer(opt_cfg).init(params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _zero1ify(spec, shape, mesh):
    """ZeRO-1: give an optimizer-state leaf one extra sharding over the
    'data' axis on its largest unsharded divisible dim."""
    if mesh is None or "data" not in mesh.shape:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for p in parts if p
            for a in ((p,) if isinstance(p, str) else p)}
    if "data" in used:
        return spec
    n = mesh.shape["data"]
    best = None
    for i, (d, p) in enumerate(zip(shape, parts)):
        if p is None and d >= n and d % n == 0:
            if best is None or d > shape[best]:
                best = i
    if best is None:
        return spec
    parts[best] = "data"
    return PartitionSpec(*parts)


def train_state_pspecs(model: Model, opt_cfg: opt_mod.OptConfig, mesh, rules,
                       zero1: bool = False) -> dict:
    """Each state tensor's PartitionSpec over `mesh` (data: nothing is
    placed).  Optimizer state inherits its parameter's spec (adafactor's
    row/col statistics drop the reduced axis); with zero1 it is also
    sharded over 'data'."""
    pspecs = convert.flatten(param_pspecs(model.param_metas(), mesh, rules))
    if opt_cfg.kind == "adafactor":
        def one(spec):
            parts = tuple(spec)
            if len(parts) >= 2:
                return {"vr": PartitionSpec(*parts[:-1]),
                        "vc": PartitionSpec(*(parts[:-2] + parts[-1:]))}
            return {"v": PartitionSpec(*parts)}
        opt = {"f": {k: one(s) for k, s in pspecs.items()}}
    else:
        opt = {name: dict(pspecs) for name in
               (("m", "v") if opt_cfg.kind == "adamw" else ("m",))}
    if zero1:
        shapes = abstract_train_state(model, opt_cfg)["opt"]

        def z1(specs, abstract):
            if isinstance(specs, dict):
                return {k: z1(specs[k], abstract[k]) for k in specs}
            return _zero1ify(specs, tuple(abstract.shape), mesh)
        opt = z1(opt, shapes)
    return {"params": pspecs, "opt": opt, "step": PartitionSpec()}


def loss_and_grads(model: Model, params: dict, batch: dict):
    """(loss, {path: gradient}) of `model` computing with `params` (the
    stacked layout) on `batch`: the forward and, inside the same
    `Model.bound`, the backward (remat recomputes with these weights).
    Each gradient comes back stacked, in its weight's dtype."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with model.bound(convert.unstack_params(model.cfg, leaves)):
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


def build_train_step(model: Model, opt_cfg: opt_mod.OptConfig,
                     n_microbatches: int = 1,
                     accum_dtype: str = "float32") -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    Gradient accumulation: the global batch is split along axis 0 into
    n_microbatches chunks, one forward and backward each, bounding live
    activation memory.  With one microbatch the gradients keep the
    weights' dtype; with more they are summed in `accum_dtype` and
    divided by the count, the loss summed in float32.  Then the global
    norm clip and the update.  metrics: loss, grad_norm (0-d device
    tensors) and lr (a 0-d host tensor)."""
    opt = opt_mod.make_optimizer(opt_cfg)
    acc_dt = opt_mod.DTYPES[accum_dtype]

    def train_step(state, batch):
        params = state["params"]
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if n_microbatches == 1:
            loss, grads = loss_and_grads(model, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{n_microbatches} microbatches")
            rows = b // n_microbatches
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = {k: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for k, p in params.items()}
            for i in range(n_microbatches):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                mb_loss, g = loss_and_grads(model, params, mb)
                loss = loss + mb_loss
                for k, a in grads.items():
                    a.add_(g[k].to(a.dtype))
                del g
            loss = loss / n_microbatches
            for g in grads.values():
                g.div_(n_microbatches)

        grads, grad_norm = opt_mod.clip_by_global_norm(
            grads, opt_cfg.grad_clip)
        new_params, new_opt = opt.update(grads, state["opt"], params,
                                         state["step"])
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "lr": opt_mod.cosine_schedule(opt_cfg, state["step"])}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return train_step


# ------------------------------------------------------------ the tree

def state_tree(state: dict) -> dict:
    """A train state as the reference's nested tree (what its
    checkpoint holds): {"opt", "params": nested by path, "step": int32}."""
    step = state["step"]
    return {"opt": {name: convert.nest(part)
                    for name, part in state["opt"].items()},
            "params": convert.nest(state["params"]),
            "step": (step if isinstance(step, torch.Tensor)
                     else np.asarray(step, np.int32))}


def state_from_tree(tree: dict) -> dict:
    """The inverse of `state_tree` (tensor leaves)."""
    def flat(part):
        out = {}
        for path, leaf in convert.flatten(part).items():
            stem, _, last = path.rpartition(".")
            if last in ("vr", "vc", "v") and stem:     # adafactor's stats
                out.setdefault(stem, {})[last] = leaf
            else:
                out[path] = leaf
        return out
    return {"params": convert.flatten(tree["params"]),
            "opt": {name: (flat(part) if name == "f"
                           else convert.flatten(part))
                    for name, part in tree["opt"].items()},
            "step": int(tree["step"])}
