"""Whole models of the ssm (mamba2), hybrid (zamba2), moe (grok-1,
kimi-k2) and encdec (whisper) families against `repro.models`, on the
CPU in float32 at their smoke widths.

The reference's weights reach the port through
`convert.params_from_numpy`; inputs come from numpy seeds.  Tolerances:
  * cross attention: OP_TOL (atol 2e-5 / rtol 1e-5), one block of
    float32 ops;
  * logits and cache entries against the reference's: LOGIT_TOL (atol
    2e-4 / rtol 1e-4), two layers of float32 ops in other orders;
  * the port's decode steps against its own forward: the reference
    test's rtol = atol = 2e-2 (tests/test_arch_smoke.py).
The MoE archs run at capacity factor 8.0, as the reference test does:
no assignment drops, so forward and decode compute the same function.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import layers as JL
from repro.models import model as jmodel_mod
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import cache_metas

OP_TOL = dict(atol=2e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
DECODE_TOL = dict(atol=2e-2, rtol=2e-2)
FAMILY_ARCHS = ["mamba2-370m", "zamba2-1.2b", "grok-1-314b",
                "kimi-k2-1t-a32b", "whisper-small"]
B = 2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _pair(arch, **changes):
    """(JAX model, JAX params, port model) with the same weights."""
    changes = dict(remat=False, moe_capacity_factor=8.0, **changes)
    jm = JModel(dataclasses.replace(jget_config(arch).smoke(), **changes))
    params = jm.init(jax.random.PRNGKey(4))
    cfg = dataclasses.replace(get_config(arch).smoke(), **changes)
    model = Model(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return jm, params, model


def _batch(cfg, S, seed=11):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.family == "encdec":
        batch["enc_input"] = rng.standard_normal(
            (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _jb(batch):
    return {k: _j(v) for k, v in batch.items()}


def _assert_caches_equal(cache, jc):
    assert set(cache) == set(jc)
    assert cache["pos"] == int(jc["pos"])
    for name in set(cache) - {"pos"}:
        want = np.asarray(jc[name])
        assert cache[name].shape == want.shape, name
        assert str(cache[name].dtype).split(".")[-1] == want.dtype.name
        np.testing.assert_allclose(cache[name].numpy(), want,
                                   err_msg=name, **LOGIT_TOL)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_steps_track_forward_and_the_reference(arch):
    """Prefill 8 tokens, then 4 decode steps: each step's logits against
    the reference's and against the port's forward over the tokens so
    far; every cache entry (k/v, xk/xv, conv, state, ak/av) against the
    reference's after the prefill and after the last step."""
    jm, params, model = _pair(arch)
    cfg = model.cfg
    batch = _batch(cfg, 12)
    tokens = batch["tokens"]
    full = model.forward(_tb(batch)).numpy()
    np.testing.assert_allclose(full, np.asarray(jm.forward(
        params, _jb(batch))), **LOGIT_TOL)

    pre = dict(batch, tokens=tokens[:, :8])
    cache = model.init_cache(B, 16)
    jc = jm.init_cache(B, 16)
    logits, cache = model.prefill(_tb(pre), cache)
    jlogits, jc = jm.prefill(params, _jb(pre), jc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(logits.numpy(), full[:, 7], **DECODE_TOL)
    _assert_caches_equal(cache, jc)
    for i in range(8, 12):
        logits, cache = model.decode_step(_t(tokens[:, i:i + 1]), cache)
        jlogits, jc = jm.decode_step(params, _j(tokens[:, i:i + 1]), jc)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(logits.numpy(), full[:, i], **DECODE_TOL)
    assert cache["pos"] == 12
    _assert_caches_equal(cache, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_metas_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for enc_len in (None, 40):
        mine = {k: (m.shape, m.axes, m.dtype)
                for k, m in cache_metas(cfg, 3, 64, enc_len).items()}
        theirs = {k: (m.shape, m.axes, m.dtype) for k, m in
                  jmodel_mod.cache_metas(jcfg, 3, 64, enc_len).items()}
        assert mine == theirs
    if cfg.family == "hybrid":           # zamba2: 38 layers, every 6th
        assert mine["ak"][0][0] == 7
    model = Model(cfg.smoke(), device="cpu", dtype=torch.bfloat16,
                  seed=None)
    cache = model.init_cache(2, 8, enc_len=5)
    for k, m in cache_metas(model.cfg, 2, 8, 5).items():
        if k == "pos":
            assert cache[k] == 0
        else:
            assert cache[k].shape == m.shape
            assert cache[k].dtype == (torch.float32 if k == "state"
                                      else torch.bfloat16)
            assert not cache[k].any()


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_prefill_into_a_used_cache_raises(arch):
    """The reference's prefill restarts the SSM state from zeros whatever
    the cache holds, so a prefill at pos != 0 silently drops the state;
    the port raises instead (a divergence kept on purpose)."""
    jm, params, model = _pair(arch)
    batch = _batch(model.cfg, 8)
    cache = model.init_cache(B, 20)
    _, cache = model.prefill(_tb(batch), cache)
    state_before = cache["state"].clone()
    with pytest.raises(ValueError, match="pos 8"):
        model.prefill(_tb(batch), cache)
    assert torch.equal(cache["state"], state_before)     # nothing written
    # what the reference does instead: the second prefill's logits are
    # a fresh prefill's, the first prompt's state is gone
    jc = jm.init_cache(B, 20)
    jfirst, jc = jm.prefill(params, _jb(batch), jc)
    jagain, jc = jm.prefill(params, _jb(batch), jc)
    if arch == "mamba2-370m":
        np.testing.assert_array_equal(np.asarray(jagain), np.asarray(jfirst))
        assert int(jc["pos"]) == 16


def test_ssm_prompt_must_fill_whole_chunks():
    """A prompt above the chunk (128) must be a multiple of it: 130
    tokens raise in both packages."""
    jm, params, model = _pair("mamba2-370m")
    batch = _batch(model.cfg, 130)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        model.forward(_tb(batch))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        model.prefill(_tb(batch), model.init_cache(B, 140))
    with pytest.raises(AssertionError, match="multiple of chunk"):
        jm.forward(params, _jb(batch))


def test_hybrid_shared_block_takes_the_chunked_branch():
    """zamba2's shared attention block inside a prefill of 256 tokens
    into a 2,560-row cache: attention's KV-chunked branch (S > 1, T >
    2048, T % 512 == 0), as in the reference."""
    T_max = 2560
    assert T_max > L.FLASH_THRESHOLD and T_max % L.FLASH_KV_CHUNK == 0
    jm, params, model = _pair("zamba2-1.2b")
    batch = _batch(model.cfg, 256)
    logits, cache = model.prefill(_tb(batch), model.init_cache(B, T_max))
    jlogits, jc = jm.prefill(params, _jb(batch), jm.init_cache(B, T_max))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _assert_caches_equal(cache, jc)
    full = model.forward(_tb(batch)).numpy()
    np.testing.assert_allclose(logits.numpy(), full[:, -1], **DECODE_TOL)


def _attn_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rng.standard_normal((D, H * dh)), "wk": rng.standard_normal(
        (D, K * dh)), "wv": rng.standard_normal((D, K * dh)),
        "wo": rng.standard_normal((H * dh, D))}
    p = {k: (v / np.sqrt(v.shape[0])).astype(np.float32)
         for k, v in p.items()}
    x = rng.standard_normal((B, 5, D)).astype(np.float32)
    enc = rng.standard_normal((B, 9, D)).astype(np.float32)
    return p, x, enc


@pytest.mark.parametrize("with_cache", [False, True])
def test_cross_attention_matches_the_reference(with_cache):
    """whisper's cross attention: K/V from the encoder output (x_kv), or
    from a cache holding xk / xv, which is read and never written; no
    rope, not causal."""
    cfg = get_config("whisper-small").smoke()
    jcfg = jget_config("whisper-small").smoke()
    p, x, enc = _attn_inputs(cfg, 12)
    pos = np.tile(np.arange(5, dtype=np.int32), (B, 1))
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: _j(v) for k, v in p.items()}
    want, _ = JL.attention(_j(x), jp, jcfg, None, None, x_kv=_j(enc),
                           q_positions=_j(pos), causal=False,
                           use_rope=False)
    if with_cache:
        K, dh = cfg.n_kv_heads, cfg.head_dim
        xk = (enc @ p["wk"]).reshape(B, 9, K, dh)
        xv = (enc @ p["wv"]).reshape(B, 9, K, dh)
        cache = {"xk": _t(xk.copy()), "xv": _t(xv.copy())}
        got, new = L.attention(_t(x), tp, cfg, q_positions=_t(pos),
                               cache=cache, causal=False, use_rope=False)
        jgot, _ = JL.attention(_j(x), jp, jcfg, None, None,
                               q_positions=_j(pos),
                               cache={"xk": _j(xk), "xv": _j(xv)},
                               causal=False, use_rope=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **OP_TOL)
        assert new is None
        np.testing.assert_array_equal(cache["xk"].numpy(), xk)
    else:
        got, new = L.attention(_t(x), tp, cfg, x_kv=_t(enc),
                               q_positions=_t(pos), causal=False,
                               use_rope=False)
        assert new is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    # rope never applies to cross attention, even with use_rope=True
    roped, _ = L.attention(_t(x), tp, cfg, x_kv=_t(enc),
                           q_positions=_t(pos + 7), causal=False)
    np.testing.assert_allclose(roped.numpy(), got.numpy(), **OP_TOL)


def test_ssm_and_moe_init_follow_the_reference_rules():
    cfg = get_config("mamba2-370m").smoke()
    model = Model(cfg, device="cpu", seed=3)
    mix = model.layers[1].mixer
    a = torch.exp(mix["a_log"])                       # log U(1, 16)
    assert bool(((a >= 1) & (a <= 16)).all()) and a.std() > 0
    dt = torch.nn.functional.softplus(mix["dt_bias"])  # softplus^-1 U
    assert bool(((dt >= 1e-3 - 1e-7) & (dt <= 0.1 + 1e-7)).all())
    assert torch.equal(mix["d_skip"], torch.ones_like(mix["d_skip"]))
    assert torch.equal(mix["norm_scale"], torch.ones_like(mix["norm_scale"]))
    assert torch.equal(model.layers[0].norm["scale"],
                       torch.ones(cfg.d_model))
    w = mix["wx"]                                     # fan_in = d_model
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    mcfg = get_config("kimi-k2-1t-a32b").smoke()
    moe_model = Model(mcfg, device="cpu", seed=3)
    wg = moe_model.layers[0].mlp["wg"]                # (E, D, F), by slice
    assert abs(float(wg.std()) * np.sqrt(mcfg.d_model) - 1.0) < 0.05
    assert not torch.equal(wg[0], wg[1])
    assert torch.equal(Model(mcfg, device="cpu", seed=3).layers[0]
                       .mlp["wg"], wg)
