"""Optimizers, the counterpart of `repro.training.optimizer` in plain
torch ops.

* adamw     — AdamW with dtype-configurable moment storage (bfloat16
              moments halve optimizer memory; the update math is fp32
              whatever the storage dtype).
* adafactor — factored second moment (rank-1 row/col statistics); no m.
* sgdm      — momentum baseline.

Parameters, gradients and state are dicts {name: tensor}, each tensor a
leaf of the reference's tree in its shape (a model's layer weights
stacked on a leading L axis: `models.convert.stack_params`), so the
reference's per-leaf rules hold leaf for leaf.  init(params) -> state;
update(grads, state, params, step) -> (new_params, new_state), new
tensors throughout (the inputs are never written).  The update math is
fp32, cast back to each tensor's dtype, in the reference's operation
order; the step's scalars (lr, bias corrections, Adafactor's decay) are
float32 0-d tensors, as the reference's are.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["OptConfig", "make_optimizer", "global_norm", "clip_by_global_norm",
           "cosine_schedule"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor | sgdm
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # bfloat16 halves optimizer memory
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to cfg.lr, then a cosine to cfg.lr * min_lr_frac at
    total_steps; a float32 0-d tensor on the host."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tensors])))


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale in each gradient's own dtype (an fp32 copy of the whole
    tree is what this avoids).  -> (clipped grads, the norm before)."""
    gn = global_norm(grads.values())
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, gn


_CHUNK_THRESHOLD = 1 << 28      # elements; ~0.5 GB bf16


def _leaves(x):
    return list(x.values()) if isinstance(x, dict) else [x]


def _index(x, i):
    return {k: v[i] for k, v in x.items()} if isinstance(x, dict) else x[i]


def _stack_outs(outs: list):
    """Per-slice results (tuples of tensors or of dicts) stacked back on
    the leading axis."""
    def stack(parts):
        if isinstance(parts[0], dict):
            return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        return torch.stack(parts)
    return tuple(stack(list(col)) for col in zip(*outs))


def _chunked_leafwise(fn, p, *rest):
    """The reference's rule: a leaf of >= 2^28 elements whose state is
    aligned with it on the leading (layer-stack) axis is updated one
    slice of that axis at a time; any other leaf whole.  For Adafactor
    this decides the reach of its update-clipping RMS (a layer, or the
    whole stack), so it is kept exactly."""
    aligned = all(r.dim() >= 1 and r.shape[0] == p.shape[0]
                  for x in rest for r in _leaves(x))
    if (p.numel() >= _CHUNK_THRESHOLD and p.dim() >= 2 and p.shape[0] > 1
            and aligned):
        return _stack_outs([fn(p[i], *(_index(x, i) for x in rest))
                            for i in range(p.shape[0])])
    return fn(p, *rest)


def _elementwise(fn, p, *rest):
    """fn on slices of the leading axis of at most 2^28 elements each (a
    single row still larger is split along its own leading axis), the
    results written into one output a tensor: the bound on the fp32
    temporaries that the reference gets from `_chunked_leafwise`.  fn
    must be elementwise, returning tensors shaped like (p, *rest)."""
    if p.numel() <= _CHUNK_THRESHOLD or p.dim() == 0:
        return fn(p, *rest)
    if p.shape[0] == 1:
        return tuple(t[None] for t in _elementwise(fn, p[0],
                                                   *(r[0] for r in rest)))
    rows = max(1, _CHUNK_THRESHOLD // p[0].numel())
    outs = None
    for a in range(0, p.shape[0], rows):
        part = _elementwise(fn, p[a:a + rows], *(r[a:a + rows] for r in rest))
        if outs is None:
            outs = [torch.empty((p.shape[0],) + t.shape[1:], dtype=t.dtype,
                                device=t.device) for t in part]
        for o, t in zip(outs, part):
            o[a:a + rows] = t
    return tuple(outs)


class _Opt:
    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def _zeros(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.zeros(shape, dtype=DTYPES[self.cfg.state_dtype],
                           device=like.device)

    def init(self, params: dict) -> dict:
        raise NotImplementedError

    def update(self, grads: dict, state: dict, params: dict, step):
        raise NotImplementedError


class _AdamW(_Opt):
    def init(self, params):
        return {"m": {k: self._zeros(p.shape, p) for k, p in params.items()},
                "v": {k: self._zeros(p.shape, p) for k, p in params.items()}}

    def update(self, grads, state, params, step):
        c = self.cfg
        lr = cosine_schedule(c, step)
        t = _f32(step) + 1.0
        # divisors on the weights' device: CUDA divides by a host scalar
        # as a product with its reciprocal, a rounding more
        dev = next(iter(params.values())).device
        bc1 = (1.0 - c.b1 ** t).to(dev)
        bc2 = (1.0 - c.b2 ** t).to(dev)

        def upd(p, g, m, v):
            g = g.float()
            mf = c.b1 * m.float() + (1 - c.b1) * g
            vf = c.b2 * v.float() + (1 - c.b2) * g * g
            step_ = (mf / bc1) / (torch.sqrt(vf / bc2) + c.eps)
            decay = c.weight_decay * p.float()
            new_p = p.float() - lr * (step_ + decay)
            return new_p.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            new_p[k], new_m[k], new_v[k] = _elementwise(
                upd, p, grads[k], state["m"][k], state["v"][k])
        return new_p, {"m": new_m, "v": new_v}


class _Adafactor(_Opt):
    """Factored second moment: for >= 2-D leaves row/col mean-square
    statistics instead of the full tensor (O(n+m) vs O(nm)); a stacked
    leaf's rows are its leading axes, as in the reference."""

    def init(self, params):
        def one(p):
            if p.dim() >= 2:
                return {"vr": self._zeros(p.shape[:-1], p),
                        "vc": self._zeros(p.shape[:-2] + p.shape[-1:], p)}
            return {"v": self._zeros(p.shape, p)}
        return {"f": {k: one(p) for k, p in params.items()}}

    def update(self, grads, state, params, step):
        c = self.cfg
        lr = cosine_schedule(c, step)
        t = _f32(step) + 1.0
        beta = 1.0 - t ** -0.8                       # Adafactor decay

        def upd(p, g, f):
            g = g.float()
            g2 = g * g + 1e-30
            if p.dim() >= 2:
                vr = beta * f["vr"].float() + (1 - beta) * g2.mean(-1)
                vc = beta * f["vc"].float() + (1 - beta) * g2.mean(-2)
                denom = (vr[..., :, None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None],
                                       min=1e-30))
                step_ = g / (torch.sqrt(denom) + c.eps)
                nf = {"vr": vr.to(f["vr"].dtype), "vc": vc.to(f["vc"].dtype)}
            else:
                v = beta * f["v"].float() + (1 - beta) * g2
                step_ = g / (torch.sqrt(v) + c.eps)
                nf = {"v": v.to(f["v"].dtype)}
            # update clipping (Adafactor RMS-1 rule)
            rms = torch.sqrt(torch.mean(step_ * step_) + 1e-30)
            step_ = step_ / torch.clamp(rms, min=1.0)
            new_p = (p.float()
                     - lr * (step_ + c.weight_decay * p.float()))
            return new_p.to(p.dtype), nf

        new_p, new_f = {}, {}
        for k, p in params.items():
            new_p[k], new_f[k] = _chunked_leafwise(upd, p, grads[k],
                                                   state["f"][k])
        return new_p, {"f": new_f}


class _SGDM(_Opt):
    def init(self, params):
        return {"m": {k: self._zeros(p.shape, p) for k, p in params.items()}}

    def update(self, grads, state, params, step):
        c = self.cfg
        lr = cosine_schedule(c, step)

        def upd(p, g, m):
            mf = c.b1 * m.float() + g.float()
            new_p = p.float() - lr * mf
            return new_p.to(p.dtype), mf.to(m.dtype)

        new_p, new_m = {}, {}
        for k, p in params.items():
            new_p[k], new_m[k] = _elementwise(upd, p, grads[k],
                                              state["m"][k])
        return new_p, {"m": new_m}


def make_optimizer(cfg: OptConfig) -> _Opt:
    return {"adamw": _AdamW, "adafactor": _Adafactor,
            "sgdm": _SGDM}[cfg.kind](cfg)
