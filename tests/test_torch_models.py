"""The port's LM stack (`repro_torch.models`) against `repro.models`, on
the CPU in float32.

The JAX side runs as its own tests run it (`smoke()` configs, float32,
`remat=False`), and its weights reach the port through
`convert.params_from_numpy`, so both packages compute with the same
numbers.  Inputs come from numpy seeds.  Tolerances:
  * norms, rope, mlp, attention core: atol 2e-5 / rtol 1e-5 (float32
    ops of XLA and torch: the same formulas, other summation orders and
    transcendental implementations);
  * logits of forward / prefill / decode against the reference's: atol
    2e-4 / rtol 1e-4 (two layers of the above; logits are O(1-5));
  * the port's decode(prefill(prompt)) against its own forward: the
    reference test's rtol = atol = 2e-2 (tests/test_arch_smoke.py).
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import layers as JL
from repro.models import model as jmodel_mod
from repro.models import transformer as JT
from repro.models.config import SHAPES as JSHAPES
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import SHAPES, Model, batch_metas, concrete_batch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy, params_to_numpy

OP_TOL = dict(atol=2e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
DECODE_TOL = dict(atol=2e-2, rtol=2e-2)
MODEL_ARCHS = ["qwen3-1.7b", "qwen2.5-14b", "chatglm3-6b",
               "nemotron-4-340b", "paligemma-3b", "grok-1-314b",
               "kimi-k2-1t-a32b", "mamba2-370m", "zamba2-1.2b",
               "whisper-small"]
B = 2
SEQ = 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# Layers.
# ---------------------------------------------------------------------------

def test_norms_match_the_reference():
    rng = _rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        L.rms_norm(_t(x), _t(scale), 1e-6).numpy(),
        np.asarray(JL.rms_norm(_j(x), _j(scale), 1e-6)), **OP_TOL)
    np.testing.assert_allclose(
        L.layer_norm(_t(x), _t(scale), _t(bias), 1e-5).numpy(),
        np.asarray(JL.layer_norm(_j(x), _j(scale), _j(bias), 1e-5)),
        **OP_TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_the_reference(fraction):
    rng = _rng(2)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 7)).astype(np.int32)
    got = L.rope(_t(x), _t(pos), fraction=fraction, theta=1e6).numpy()
    want = np.asarray(JL.rope(_j(x), _j(pos), fraction=fraction,
                              theta=1e6))
    np.testing.assert_allclose(got, want, **OP_TOL)
    if fraction < 1:                     # the pass-through half untouched
        np.testing.assert_array_equal(got[..., 16:], x[..., 16:])


@pytest.mark.parametrize("mlp_type", ["swiglu", "squared_relu", "gelu"])
def test_mlp_matches_the_reference(mlp_type):
    cfg = dataclasses.replace(get_config("qwen3-1.7b").smoke(),
                              mlp_type=mlp_type)
    rng = _rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    names = ("wg", "wu", "wo") if mlp_type == "swiglu" else ("wi", "wo")
    p = {n: (rng.standard_normal(
        (cfg.d_ff, cfg.d_model) if n == "wo" else (cfg.d_model, cfg.d_ff))
        / np.sqrt(cfg.d_model)).astype(np.float32) for n in names}
    got = L.mlp(_t(x), {n: _t(v) for n, v in p.items()}, cfg).numpy()
    want = np.asarray(JL.mlp(_j(x), {n: _j(v) for n, v in p.items()}, cfg,
                             None, None))
    np.testing.assert_allclose(got, want, **OP_TOL)


# (S, T, kv_valid, prefix_len, causal): the plain branch (decode, prompt,
# prefix-LM, bidirectional) and the chunked branch at T 2560 = 5 chunks
ATTN_CASES = {
    "decode": (1, 64, [40, 64], 0, True),
    "prompt": (8, 64, [8, 30], 0, True),
    "prefix": (8, 64, [20, 20], 6, True),
    "bidirectional": (8, 64, None, 0, False),
    "chunked": (8, 2560, [2100, 2560], 0, True),
    "chunked-prefix": (8, 2560, [2560, 700], 300, True),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_core_matches_the_reference(case):
    S, Tn, valid, prefix, causal = ATTN_CASES[case]
    chunked = S > 1 and Tn > L.FLASH_THRESHOLD and \
        Tn % L.FLASH_KV_CHUNK == 0
    assert chunked == case.startswith("chunked")
    rng = _rng(4)
    H, K, dh = 4, 2, 32                       # GQA: two query heads a KV head
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, Tn, K, dh)).astype(np.float32)
    v = rng.standard_normal((B, Tn, K, dh)).astype(np.float32)
    end = np.array(valid if valid is not None else [Tn, Tn])
    qpos = (end[:, None] - S + np.arange(S)[None]).astype(np.int32)
    kw = dict(causal=causal, prefix_len=prefix)
    kv = None if valid is None else np.asarray(valid, np.int32)
    got = L.attn_core(_t(q), _t(k), _t(v), q_positions=_t(qpos),
                      kv_valid_len=None if kv is None else _t(kv), **kw)
    want = JL.attn_core(_j(q), _j(k), _j(v), q_positions=_j(qpos),
                        kv_valid_len=None if kv is None else _j(kv), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


# ---------------------------------------------------------------------------
# Metas, conversion, an unknown family.
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_param_metas_equal_the_reference(arch):
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (get_config(arch).smoke(), jget_config(arch).smoke())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        mine = {k: (m.shape, m.axes, m.dtype)
                for k, m in _flat(T.param_metas(cfg))}
        theirs = {k: (m.shape, m.axes, m.dtype)
                  for k, m in _flat(JT.param_metas(jcfg))}
        assert mine == theirs
    cfg = get_config(arch).smoke()
    assert Model(cfg, device="cpu").n_params() == \
        JModel(jget_config(arch).smoke()).n_params()
    for sc in SHAPES:
        mine = {k: (m.shape, m.axes, m.dtype)
                for k, m in batch_metas(cfg, SHAPES[sc]).items()}
        theirs = {k: (m.shape, m.axes, m.dtype) for k, m in
                  jmodel_mod.batch_metas(jget_config(arch).smoke(),
                                         JSHAPES[sc]).items()}
        assert mine == theirs
    gen = torch.Generator().manual_seed(0)
    batch = concrete_batch(cfg, SHAPES["decode_32k"], gen)
    assert batch["tokens"].shape == (128, 1)
    assert batch["tokens"].dtype == torch.int32


def test_unknown_family_raises():
    cfg = dataclasses.replace(get_config("qwen3-1.7b").smoke(),
                              family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        T.param_metas(cfg)
    with pytest.raises(ValueError, match="rnn"):
        Model(cfg, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_for_bit(dtype):
    jcfg = dataclasses.replace(jget_config("qwen2.5-14b").smoke(),
                               dtype=dtype)
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(
        jax.random.PRNGKey(3)))
    cfg = dataclasses.replace(get_config("qwen2.5-14b").smoke(), dtype=dtype)
    model = Model(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_numpy(cfg, tree))
    assert model.embed["tokens"].dtype == T.DTYPES[dtype]
    back = params_to_numpy(model)
    flat_a, flat_b = dict(_flat(tree)), dict(_flat(back))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert flat_a[k].dtype == flat_b[k].dtype, k
        assert flat_a[k].tobytes() == flat_b[k].tobytes(), k
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(cfg, {"embed": tree["embed"]})


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-small"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_stacks_bit_for_bit(arch, dtype):
    """zamba2's unstacked `shared` block and whisper's encoder layers,
    stacked over n_enc_layers, cross both ways bit for bit."""
    jcfg = dataclasses.replace(jget_config(arch).smoke(), dtype=dtype,
                               n_enc_layers=min(jget_config(arch)
                                                .n_enc_layers, 3))
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype,
                              n_enc_layers=jcfg.n_enc_layers)
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(
        jax.random.PRNGKey(5)))
    model = Model(cfg, device="cpu", seed=None)
    sd = params_from_numpy(cfg, tree)
    model.load_state_dict(sd)
    if cfg.family == "hybrid":
        assert "shared.attn.wq" in sd
    else:
        assert cfg.n_enc_layers == 3 != cfg.n_layers
        assert "encoder.layers.2.attn.wq" in sd
        assert "encoder.final_norm.scale" in sd
    back = params_to_numpy(model)
    flat_a, flat_b = dict(_flat(tree)), dict(_flat(back))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert flat_a[k].dtype == flat_b[k].dtype, k
        assert flat_a[k].tobytes() == flat_b[k].tobytes(), k


def test_init_follows_the_reference_rules():
    cfg = get_config("qwen2.5-14b").smoke()       # qkv bias
    model = Model(cfg, device="cpu", seed=5)
    lay = model.layers[1]
    assert torch.equal(lay.attn_norm["scale"], torch.ones(cfg.d_model))
    assert torch.equal(lay.attn["bq"], torch.zeros_like(lay.attn["bq"]))
    std = float(model.embed["tokens"].std())
    assert abs(std - 0.02) < 0.002
    w = lay.mlp["wo"]                              # fan_in = d_ff
    assert abs(float(w.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    again = Model(cfg, device="cpu", seed=5)
    assert torch.equal(again.layers[1].mlp["wo"], w)


# ---------------------------------------------------------------------------
# Whole models with the reference's weights.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """arch -> (JAX model, JAX params, port model, batch as numpy), made
    once an arch."""
    made = {}

    def get(arch):
        if arch not in made:
            # the MoE archs at capacity factor 8.0, as the reference
            # test: no assignment drops, forward = decode
            kw = dict(remat=False, moe_capacity_factor=8.0)
            jcfg = dataclasses.replace(jget_config(arch).smoke(), **kw)
            jm = JModel(jcfg)
            params = jm.init(jax.random.PRNGKey(2))
            cfg = dataclasses.replace(get_config(arch).smoke(), **kw)
            model = Model(cfg, device="cpu", seed=None)
            model.load_state_dict(params_from_numpy(
                cfg, jax.tree.map(np.asarray, params)))
            rng = _rng(7)
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ))
                     .astype(np.int32)}
            if cfg.family == "vlm":
                batch["vision"] = rng.standard_normal(
                    (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
            if cfg.family == "encdec":
                batch["enc_input"] = rng.standard_normal(
                    (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
            made[arch] = (jm, params, model, batch)
        return made[arch]
    return get


def _jb(batch):
    return {k: _j(v) for k, v in batch.items()}


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_forward_matches_the_reference(pair, arch):
    jm, params, model, batch = pair(arch)
    want = np.asarray(jm.forward(params, _jb(batch)))
    got = model.forward(_tb(batch)).numpy()
    assert got.shape == (B, SEQ, model.cfg.vocab_size)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_decode_matches_forward_and_reference(pair, arch):
    """The reference's test_prefill_decode_matches_forward in port form,
    and the port's prefill and decode logits against the reference's."""
    jm, params, model, batch = pair(arch)
    cfg = model.cfg
    nv = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    tokens = batch["tokens"]
    full = model.forward(_tb(batch)).numpy()
    t_max = SEQ + nv + 4
    pre = dict(batch, tokens=tokens[:, :-1])

    cache = model.init_cache(B, t_max)
    logits_pre, cache = model.prefill(_tb(pre), cache)
    assert cache["pos"] == SEQ - 1 + nv
    logits_dec, cache = model.decode_step(_t(tokens[:, -1:]), cache)
    assert cache["pos"] == SEQ + nv
    np.testing.assert_allclose(logits_pre.numpy(), full[:, -2], **DECODE_TOL)
    np.testing.assert_allclose(logits_dec.numpy(), full[:, -1], **DECODE_TOL)

    jc = jm.init_cache(B, t_max)
    jpre, jc = jm.prefill(params, _jb(pre), jc)
    jdec, jc = jm.decode_step(params, _j(tokens[:, -1:]), jc)
    np.testing.assert_allclose(logits_pre.numpy(), np.asarray(jpre),
                               **LOGIT_TOL)
    np.testing.assert_allclose(logits_dec.numpy(), np.asarray(jdec),
                               **LOGIT_TOL)
    assert set(cache) == set(jc)
    for name in set(cache) - {"pos"}:
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jc[name]), err_msg=name,
                                   **LOGIT_TOL)


def test_cache_overflow_raises_and_the_last_row_agrees(pair):
    """A cache filled to its last row agrees with the reference; a write
    past T_max raises (the reference's dynamic_update_slice would clamp
    it onto the last rows instead)."""
    jm, params, model, batch = pair("qwen3-1.7b")
    tokens = batch["tokens"]
    t_max = SEQ
    cache = model.init_cache(B, t_max)
    _, cache = model.prefill(_tb(dict(batch, tokens=tokens[:, :-1])), cache)
    logits, cache = model.decode_step(_t(tokens[:, -1:]), cache)
    assert cache["pos"] == t_max
    jc = jm.init_cache(B, t_max)
    _, jc = jm.prefill(params, _jb(dict(batch, tokens=tokens[:, :-1])), jc)
    jlog, jc = jm.decode_step(params, _j(tokens[:, -1:]), jc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **LOGIT_TOL)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jc["v"]),
                               **LOGIT_TOL)
    k_before = cache["k"].clone()
    with pytest.raises(ValueError, match="overflow"):
        model.decode_step(_t(tokens[:, -1:]), cache)
    with pytest.raises(ValueError, match="overflow"):
        model.prefill(_tb(batch), model.init_cache(B, SEQ - 1))
    assert torch.equal(cache["k"], k_before)       # nothing written


# ---------------------------------------------------------------------------
# Isolation.
# ---------------------------------------------------------------------------

PORT_MODULES = ["models/__init__.py", "models/config.py", "models/layers.py",
                "models/transformer.py", "models/model.py", "models/ssm.py",
                "models/moe.py",
                "models/convert.py", "configs/__init__.py",
                "configs/ppanns_datasets.py", "sharding/__init__.py",
                "sharding/rules.py", "serving/__init__.py",
                "serving/engine.py", "launch/serve.py", "core/ame.py",
                "core/lsh.py"] + [f"configs/{m}.py" for m in (
                    "qwen3_1p7b", "qwen2p5_14b", "chatglm3_6b",
                    "nemotron4_340b", "paligemma_3b", "grok1_314b",
                    "kimi_k2_1t", "mamba2_370m", "zamba2_1p2b",
                    "whisper_small")]


def test_ported_modules_import_neither_jax_nor_repro():
    root = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    for rel in PORT_MODULES:
        text = (root / rel).read_text()
        assert not bad.search(text), rel
    assert len(ARCHS) == 10
