"""Training of every arch at smoke width against the reference, on the
CPU in float32 (the port form of tests/test_arch_smoke.py:50
`test_train_step_loss_and_grads_finite`, with parity added).

The reference's weights reach the port through
`convert.params_from_numpy`; inputs come from numpy seeds.  Tolerances:
  * the loss: rel 1e-5 of the reference's `Model.loss` (found: <= 2.1e-7);
  * gradients against `jax.grad`, per leaf in the reference's layout:
    max|d| <= 1e-4 * max|g_ref| + 1e-6 (found: <= 7.7e-6 * max|g_ref|,
    mamba2's SSD the largest);
  * one step of the reference's jitted `build_train_step` (adamw,
    n_microbatches 2) against the port's: the weights within 2 * lr
    (an Adam step is lr * m / sqrt(v) ~ lr * sign(g) at step 0, so an
    element whose gradient is near zero could move by up to 2 lr the
    other way) and 99.9% of them within 1e-6 (found: equal for every
    arch); the moments within the gradient bar;
  * ten steps: losses within 1e-3 absolute (found: <= 1.4e-4, the MoE
    archs'); every weight within 2e-2, the most ten Adam steps at lr
    1e-3 can part two trajectories (found: <= 1.7e-3, one element of the
    MoE archs' embedding whose gradient sits near zero), and 99.9% of
    each leaf within 1e-4 (found: >= 99.997%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.training import OptConfig as JOptConfig
from repro.training import build_train_step as jbuild_train_step
from repro.training import init_train_state as jinit_train_state
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import Model
from repro_torch.models.convert import (flatten, params_from_numpy,
                                        stack_params, unstack_params)
from repro_torch.training import (OptConfig, build_train_step,
                                  init_train_state)

B, S = 2, 64
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LR = 1e-3
STEPS_ATOL = 1e-3
WEIGHTS_ATOL = 20 * LR

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, and torch's own thread pool in each would oversubscribe
    them (this file's small ops then spin for minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _batch(cfg, seed=0, B=B, S=S):
    rng = np.random.default_rng(seed)
    s_text = S - (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    tokens = rng.integers(0, cfg.vocab_size, (B, s_text)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["enc_input"] = rng.standard_normal(
            (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _models(arch, seed=1):
    jcfg = jget_config(arch).smoke()
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    cfg = get_config(arch).smoke()
    model = Model(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, model, cfg


def _np(tree):
    return flatten(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_grad(arch):
    jmodel, jparams, model, cfg = _models(arch)
    batch = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    plain = model.loss(batch)               # the model's own weights
    assert plain.grad_fn is None            # no train state: no autograd
    assert float(plain) == pytest.approx(float(jloss), rel=LOSS_RTOL)

    params = stack_params(cfg, {k: p.detach()
                                for k, p in model.named_parameters()})
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with model.bound(unstack_params(cfg, leaves)):
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    loss = float(loss.detach())
    assert np.isfinite(loss) and loss > 0
    assert loss == pytest.approx(float(jloss), rel=LOSS_RTOL)
    want = _np(jgrads)
    assert set(want) == set(leaves)
    for k, g in zip(leaves, grads):
        assert torch.isfinite(g).all(), k
        ref = want[k]
        assert g.shape == ref.shape, k
        tol = GRAD_RTOL * np.abs(ref).max() + GRAD_ATOL
        err = np.abs(g.numpy() - ref).max()
        assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    """The reference's jitted build_train_step (adamw, 2 microbatches)
    and the port's from the same weights on the same ten batches: the
    first step's weights and optimizer state, then ten steps' losses."""
    jmodel, jparams, model, cfg = _models(arch, seed=2)
    opt = dict(lr=LR, warmup_steps=0, total_steps=100)
    jstate = jinit_train_state(jmodel, JOptConfig(**opt),
                               jax.random.PRNGKey(2))
    assert jax.tree.all(jax.tree.map(
        lambda a, b: bool(jnp.array_equal(a, b)), jstate["params"],
        jparams))
    jstep = jax.jit(jbuild_train_step(jmodel, JOptConfig(**opt),
                                      n_microbatches=2))
    state = init_train_state(model, OptConfig(**opt))
    step = build_train_step(model, OptConfig(**opt), n_microbatches=2)
    jlosses, losses = [], []
    for i in range(10):
        batch = _batch(cfg, seed=100 + i, B=4, S=32)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
        if i == 0:
            assert float(m["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=1e-5)
            want = _np(jstate["params"])
            for k, p in state["params"].items():
                d = np.abs(p.numpy() - want[k])
                assert d.max() <= 2 * LR, (k, d.max())
                assert np.mean(d <= 1e-6) >= 0.999, (k, np.mean(d <= 1e-6))
            for part in ("m", "v"):
                want = _np(jstate["opt"][part])
                for k, t in state["opt"][part].items():
                    ref = want[k]
                    tol = GRAD_RTOL * np.abs(ref).max() + GRAD_ATOL
                    assert np.abs(t.numpy() - ref).max() <= tol, (part, k)
    assert state["step"] == 10
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=STEPS_ATOL)
    want = _np(jstate["params"])
    for k, p in state["params"].items():
        d = np.abs(p.numpy() - want[k])
        assert d.max() <= WEIGHTS_ATOL, (k, d.max())
        assert np.mean(d <= 1e-4) >= 0.999, (k, np.mean(d <= 1e-4))
    assert np.isfinite(losses).all()
