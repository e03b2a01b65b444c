"""The port's MoE block (`repro_torch.models.moe`) against
`repro.models.moe`, on the CPU in float32, at grok-1's and kimi-k2's
smoke widths (d_model 128, d_ff 256, 8 experts, top-2).

Held exactly: the capacity, the top-k's experts (ties to the lower
index, as `lax.top_k`), and which assignments drop at capacity factor
1.25 (the reference's stable sort, ranks and drop bin, transcribed in
jnp below).  Held within LOGIT_TOL (atol 2e-4 / rtol 1e-4): the block's
output (float32 products and sums in other orders) and the load-balance
loss.  The parameter counts of the full configs are computed from the
metas alone in both packages and held exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.model import n_active_params

LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _cfgs(arch, cf):
    return (dataclasses.replace(get_config(arch).smoke(),
                                moe_capacity_factor=cf),
            dataclasses.replace(jget_config(arch).smoke(),
                                moe_capacity_factor=cf))


def _params(cfg, seed=0, skew=0.0):
    """Router and expert weights in numpy; `skew` adds to expert 0's
    router column so that it overflows its capacity."""
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    router[:, 0] += skew / np.sqrt(D)
    return {"router": router,
            "wg": (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(
                np.float32),
            "wu": (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(
                np.float32),
            "wo": (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(
                np.float32)}


def _jax_dropped(probs, cfg, C):
    """The reference's routing (src/repro/models/moe.py, top-k to keep),
    in jnp: the kept flag of each (t, j) assignment."""
    _, sel = jax.lax.top_k(probs, cfg.experts_per_token)
    flat_e = sel.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.bincount(se, length=cfg.n_experts)
    seg_start = jnp.cumsum(counts) - counts
    rank = jnp.arange(flat_e.shape[0]) - seg_start[se]
    keep = rank < C
    return np.asarray(sel), np.asarray(keep[jnp.argsort(order)])


@pytest.mark.parametrize("cf,tokens", [(1.25, 32), (1.25, 4), (8.0, 32),
                                       (0.5, 3)])
def test_capacity_matches_the_reference(cf, tokens):
    cfg, jcfg = _cfgs("kimi-k2-1t-a32b", cf)
    assert moe.capacity(cfg, tokens) == jmoe.capacity(jcfg, tokens)
    full = get_config("kimi-k2-1t-a32b")
    assert moe.capacity(full, tokens) == jmoe.capacity(
        jget_config("kimi-k2-1t-a32b"), tokens)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    vals, idx = moe._top_k(_t(probs), 2)
    jvals, jidx = jax.lax.top_k(_j(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert idx.tolist() == [[1, 2], [0, 1], [0, 2]]


@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_block_matches_the_reference(arch, cf):
    """At cf 1.25 with expert 0 favoured some assignments drop: the
    dropped set equals the reference's exactly, and so do the outputs
    (a dropped assignment contributes nothing).  At cf 8.0 none drops."""
    cfg, jcfg = _cfgs(arch, cf)
    p = _params(cfg, seed=1, skew=3.0)
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    got = moe.moe_block(_t(x), {k: _t(v) for k, v in p.items()}, cfg)
    want = jmoe.moe_block(_j(x), {k: _j(v) for k, v in p.items()}, jcfg,
                          None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)

    T = x.shape[0] * x.shape[1]
    C = moe.capacity(cfg, T)
    probs = torch.softmax(_t(x).reshape(T, -1) @ _t(p["router"]), -1)
    _, sel = moe._top_k(probs, cfg.experts_per_token)
    order, slot, keep = moe._assign(sel, cfg.n_experts, C)
    kept = keep[torch.argsort(order)].numpy()
    jsel, jkept = _jax_dropped(_j(probs.numpy()), cfg, C)
    np.testing.assert_array_equal(sel.numpy(), jsel)
    np.testing.assert_array_equal(kept, jkept)
    if cf == 8.0:
        assert kept.all()
    else:
        assert (~kept).sum() > 0                       # drops happened
        assert (slot == cfg.n_experts * C).sum() == (~kept).sum()
    # the drops' rows: tokens whose every assignment dropped give zeros
    gone = ~kept.reshape(T, -1).any(1)
    assert torch.equal(got.reshape(T, -1)[torch.from_numpy(gone)],
                       torch.zeros((int(gone.sum()), cfg.d_model)))


def test_aux_load_balance_loss_matches_the_reference():
    cfg, jcfg = _cfgs("grok-1-314b", 1.25)
    p = _params(cfg, seed=3, skew=1.0)
    x = np.random.default_rng(4).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32)
    got = moe.aux_load_balance_loss(_t(x), {"router": _t(p["router"])}, cfg)
    want = jmoe.aux_load_balance_loss(_j(x), {"router": _j(p["router"])},
                                      jcfg)
    np.testing.assert_allclose(float(got), float(want), **LOGIT_TOL)
    assert float(got) > 1.0                  # expert 0 is favoured


@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b",
                                  "qwen3-1.7b"])
def test_n_active_params_from_metas_equals_the_reference(arch):
    """The full configs (grok-1: 316 B parameters, kimi-k2: 1.04 T) from
    the metas alone — no weight is allocated."""
    cfg, jm = get_config(arch), JModel(jget_config(arch))
    assert n_active_params(cfg) == jm.n_active_params()
    if cfg.family == "moe":
        assert n_active_params(cfg) < jm.n_params()
    else:
        assert n_active_params(cfg) == jm.n_params()
