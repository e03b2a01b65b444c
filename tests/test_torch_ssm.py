"""The port's mamba2 block (`repro_torch.models.ssm`) against
`repro.models.ssm`, on the CPU in float32, at the smoke width of
mamba2-370m (d_model 128, state 16, head_dim 32: 8 heads).

Inputs and weights come from numpy seeds and cross as numpy arrays.
Tolerances:
  * `_segsum`, `_conv_apply`: OP_TOL (atol 2e-5 / rtol 1e-5), float32
    ops in other summation orders;
  * `ssd_chunked`, `mamba_block`, `mamba_decode_step` and their states:
    LOGIT_TOL (atol 2e-4 / rtol 1e-4): chains of contractions whose
    order differs (the port writes the reference's multi-operand
    einsums as two-operand contractions);
  * the two-part long check (prefill, then decode steps, against one
    pass over every token): LOGIT_TOL too — both sides are float32 and
    compute the same function, so a gap above it is a fault, not the
    reference test's 2e-2 of a whole model.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import ssm

OP_TOL = dict(atol=2e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _cfgs(groups=1):
    """(port cfg, reference cfg) of smoke mamba2 with `groups` B/C
    groups."""
    return (dataclasses.replace(get_config("mamba2-370m").smoke(),
                                ssm_groups=groups),
            dataclasses.replace(jget_config("mamba2-370m").smoke(),
                                ssm_groups=groups))


def _params(cfg, seed=0):
    """Mixer weights drawn by the reference's init rules, in numpy."""
    rng = np.random.default_rng(seed)
    D, dI = cfg.d_model, cfg.d_inner
    GN, H, kw = cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    return {"wz": w(D, dI), "wx": w(D, dI), "wb": w(D, GN), "wc": w(D, GN),
            "wdt": w(D, H), "conv": w(kw, dI + 2 * GN),
            "a_log": np.log(rng.uniform(1, 16, H)).astype(np.float32),
            "dt_bias": np.log(np.expm1(rng.uniform(1e-3, 0.1, H))).astype(
                np.float32),
            "d_skip": rng.uniform(0.5, 1.5, H).astype(np.float32),
            "norm_scale": rng.uniform(0.5, 1.5, dI).astype(np.float32),
            "wo": w(dI, D)}


def _both(p):
    return {k: _t(v) for k, v in p.items()}, {k: _j(v) for k, v in p.items()}


def test_segsum_matches_the_reference_and_masks_before_exp():
    rng = np.random.default_rng(1)
    dA = rng.standard_normal((2, 3, 8)).astype(np.float32)
    dA[0, 0] = -60.0         # upper-triangle differences of +420: exp = inf
    got = ssm._segsum(_t(dA))
    want = np.asarray(jssm._segsum(_j(dA)))
    assert got.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, **OP_TOL)
    assert torch.isneginf(got[..., 0, 1:]).all()
    decay = torch.exp(got)
    assert torch.isfinite(decay).all()
    assert torch.equal(decay, decay.tril())


SSD_CASES = {"shorter_than_chunk": (6, 8), "four_chunks": (16, 4),
             "one_token": (1, 128)}


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_chunked_matches_the_reference(case):
    S, chunk = SSD_CASES[case]
    rng = np.random.default_rng(2)
    B, H, P, N = 2, 4, 8, 6
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.5, (B, S, H)).astype(np.float32)
    A = -rng.uniform(1, 16, H).astype(np.float32)
    Bm = rng.standard_normal((B, S, H, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, H, N)).astype(np.float32)
    y, state = ssm.ssd_chunked(_t(xh), _t(dt), _t(A), _t(Bm), _t(Cm), chunk)
    jy, jstate = jssm.ssd_chunked(_j(xh), _j(dt), _j(A), _j(Bm), _j(Cm),
                                  chunk)
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LOGIT_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                               **LOGIT_TOL)


def test_ssd_chunked_raises_when_the_chunk_does_not_divide():
    z = torch.zeros((1, 130, 2, 4))
    with pytest.raises(ValueError, match="multiple of the SSD chunk 128"):
        ssm.ssd_chunked(z, torch.ones((1, 130, 2)), -torch.ones(2),
                        torch.zeros((1, 130, 2, 3)),
                        torch.zeros((1, 130, 2, 3)), 128)


@pytest.mark.parametrize("mode", ["pad", "state"])
def test_conv_apply_matches_the_reference(mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 24)).astype(np.float32)     # S = 2
    kern = rng.standard_normal((4, 24)).astype(np.float32)
    st = (rng.standard_normal((2, 3, 24)).astype(np.float32)
          if mode == "state" else None)
    out, new = ssm._conv_apply(_t(x), _t(kern),
                               conv_state=None if st is None else _t(st))
    jout, jnew = jssm._conv_apply(_j(x), _j(kern),
                                  conv_state=None if st is None else _j(st))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **OP_TOL)
    if st is None:
        assert new is None and jnew is None
    else:                  # the last kw-1 rows of [state, x], exactly
        np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
        np.testing.assert_array_equal(new.numpy()[:, 1:], x)


def test_heads_repeat_each_group_like_jnp_repeat():
    """`_heads` expands B/C groups with jnp.repeat (each group rep times
    in a row), i.e. repeat_interleave, not Tensor.repeat."""
    cfg, jcfg = _cfgs(groups=2)
    dI, GN = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    conv_out = np.random.default_rng(4).standard_normal(
        (2, 3, dI + 2 * GN)).astype(np.float32)
    got = ssm._heads(cfg, _t(conv_out), dI, GN)
    want = jssm._heads(jcfg, _j(conv_out), dI, GN)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    Bm = got[1]                                # heads 0-3 group 0, 4-7 g1
    assert torch.equal(Bm[:, :, 3], Bm[:, :, 0])
    assert not torch.equal(Bm[:, :, 4], Bm[:, :, 0])


# (groups, S): one group, ssm_groups 2, and a prompt shorter than kw-1
BLOCK_CASES = {"g1_s16": (1, 16), "g2_s16": (2, 16), "g1_s2": (1, 2)}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_mamba_block_matches_the_reference(case):
    groups, S = BLOCK_CASES[case]
    cfg, jcfg = _cfgs(groups)
    tp, jp = _both(_params(cfg, seed=5))
    x = np.random.default_rng(6).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    y, cache = ssm.mamba_block(_t(x), tp, cfg, chunk=4)
    jy, jcache = jssm.mamba_block(_j(x), jp, jcfg, None, None, chunk=4)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LOGIT_TOL)
    np.testing.assert_allclose(cache["state"].numpy(),
                               np.asarray(jcache["state"]), **LOGIT_TOL)
    assert cache["state"].dtype == torch.float32
    np.testing.assert_allclose(cache["conv"].numpy(),
                               np.asarray(jcache["conv"]), **LOGIT_TOL)
    assert cache["conv"].shape == (2, cfg.ssm_conv - 1,
                                   cfg.d_inner + 2 * groups * cfg.ssm_state)
    if S < cfg.ssm_conv - 1:         # left-padded with zeros
        assert torch.equal(cache["conv"][:, :cfg.ssm_conv - 1 - S],
                           torch.zeros_like(cache["conv"][:, :1]))


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_decode_step_matches_the_reference(groups):
    cfg, jcfg = _cfgs(groups)
    tp, jp = _both(_params(cfg, seed=7))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    state = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state)).astype(np.float32)
    conv = rng.standard_normal(
        (2, cfg.ssm_conv - 1,
         cfg.d_inner + 2 * groups * cfg.ssm_state)).astype(np.float32)
    state_t, conv_t = _t(state), _t(conv)
    y, new = ssm.mamba_decode_step(_t(x), tp, cfg,
                                   {"state": state_t, "conv": conv_t})
    jy, jnew = jssm.mamba_decode_step(_j(x), jp, jcfg, None, None,
                                      {"state": _j(state), "conv": _j(conv)})
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LOGIT_TOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(new[name].numpy(),
                                   np.asarray(jnew[name]), **LOGIT_TOL)
    # the caller's tensors are read only
    assert np.array_equal(state_t.numpy(), state)
    assert np.array_equal(conv_t.numpy(), conv)


def test_prefill_then_decode_equals_one_pass():
    """chip_smoke's long check at module level: mamba_block (chunk 4)
    over 16 tokens, then 4 decode steps, against mamba_block (chunk 4)
    over all 20 tokens — and against the reference's 20-token pass."""
    cfg, jcfg = _cfgs()
    tp, jp = _both(_params(cfg, seed=9))
    x = np.random.default_rng(10).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    full, _ = ssm.mamba_block(_t(x), tp, cfg, chunk=4)
    jfull, _ = jssm.mamba_block(_j(x), jp, jcfg, None, None, chunk=4)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), **LOGIT_TOL)
    y, cache = ssm.mamba_block(_t(x[:, :16]), tp, cfg, chunk=4)
    steps = [y]
    for i in range(16, 20):
        yi, cache = ssm.mamba_decode_step(_t(x[:, i:i + 1]), tp, cfg, cache)
        steps.append(yi)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               **LOGIT_TOL)
