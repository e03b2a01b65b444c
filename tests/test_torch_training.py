"""The port's training substrate (`repro_torch.training`,
`repro_torch.data.loader`) against `repro.training` / `repro.data`, on
the CPU in float32: the port forms of tests/test_training.py's eight
test functions, and where the reference computes the same value the
port is held to it.

Tolerances:
  * the cosine schedule: the reference's float32 values, but where
    XLA's float32 cos (its own polynomial) and torch's differ by one ulp
    (10 of 201 arguments on [0, pi]); that ulp of cos moves lr by at
    most 0.45 * 2^-24 * lr, so the bar is 1e-7 * lr absolute, and most
    values must be equal;
  * one optimizer update on the same weights and gradients: 1e-6
    absolute on the weights and the state (the same fp32 formulas in
    the same order; reductions such as Adafactor's means and RMS sum in
    another order);
  * the microbatch bar of the reference test: loss rel 1e-4, weights
    5e-3 after one adamw step;
  * TokenStream batches: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.loader import TokenStream as JTokenStream
from repro.models import Model as JModel
from repro.training import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.data.loader import TokenStream
from repro_torch.models import Model
from repro_torch.models.convert import flatten, params_from_numpy
from repro_torch.training import (OptConfig, build_train_step,
                                  init_train_state)
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.optimizer import (clip_by_global_norm,
                                            cosine_schedule, global_norm,
                                            make_optimizer)

UPDATE_ATOL = 1e-6

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, and torch's own thread pool in each would oversubscribe
    them (this file's small ops then spin for minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _t(a):
    return torch.from_numpy(np.array(a))


def _smoke_model(arch="qwen3-1.7b", seed=0):
    """The port's smoke model with the reference's weights for `seed`."""
    jcfg = jget_config(arch).smoke()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(seed))
    cfg = get_config(arch).smoke()
    model = Model(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams)))
    return model, cfg


def test_cosine_schedule_shape():
    cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(cosine_schedule(cfg, s)) for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3, rel=1e-3)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(cfg.lr * cfg.min_lr_frac, rel=1e-2)


@pytest.mark.parametrize("cfg", [
    OptConfig(lr=1e-3, warmup_steps=10, total_steps=100),
    OptConfig(lr=3e-3, warmup_steps=5, total_steps=60, min_lr_frac=0.0),
    OptConfig(lr=0.1, warmup_steps=0, total_steps=200)])
def test_cosine_schedule_equals_the_reference(cfg):
    jcfg = jopt.OptConfig(**cfg.__dict__)
    steps = list(range(0, cfg.total_steps + 20, 3))
    got = np.array([cosine_schedule(cfg, s).numpy() for s in steps])
    want = np.array([np.asarray(jopt.cosine_schedule(jcfg, s))
                     for s in steps])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * cfg.lr)
    assert np.mean(got == want) > 0.9


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgdm"])
def test_optimizer_reduces_quadratic(kind):
    cfg = OptConfig(kind=kind, lr=0.1, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, grad_clip=1e9)
    opt = make_optimizer(cfg)
    target = {"w": torch.tensor([1.0, -2.0, 3.0]),
              "b": torch.tensor([[0.5, -0.5], [1.0, 2.0]])}
    params = {k: torch.zeros_like(v) for k, v in target.items()}
    state = opt.init(params)

    def loss(p):
        return sum(torch.sum((p[k] - target[k]) ** 2) for k in target)

    l0 = float(loss(params))
    for step in range(150):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
        params, state = opt.update(g, state, params, step)
    assert float(loss(params)) < 0.05 * l0


def _opt_inputs(rng, shapes):
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    return p, g


def _assert_trees_close(got: dict, want, atol, what):
    want = flatten(jax.tree.map(np.asarray, want))
    got = flatten(got)
    assert set(got) == set(want), what
    for k in want:
        a = got[k].float().numpy() if isinstance(got[k], torch.Tensor) \
            else np.asarray(got[k])
        np.testing.assert_allclose(a, np.asarray(want[k], np.float32),
                                   rtol=0, atol=atol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgdm"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_optimizer_update_matches_the_reference(kind, state_dtype):
    """Three updates (steps 0, 1, 7) of the same weights and gradients,
    1-D to 3-D leaves, against the reference's."""
    rng = np.random.default_rng(3)
    shapes = {"a": (5,), "b": (6, 7), "c": (3, 4, 5), "d": (2, 9)}
    cfg = OptConfig(kind=kind, lr=1e-2, warmup_steps=2, total_steps=20,
                    weight_decay=0.05, state_dtype=state_dtype)
    jcfg = jopt.OptConfig(**cfg.__dict__)
    opt, jo = make_optimizer(cfg), jopt.make_optimizer(jcfg)
    p, _ = _opt_inputs(rng, shapes)
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ts, js = opt.init(tp), jo.init(jp)
    for step in (0, 1, 7):
        _, g = _opt_inputs(rng, shapes)
        tp, ts = opt.update({k: _t(v) for k, v in g.items()}, ts, tp, step)
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                           jp, step)
        atol = UPDATE_ATOL if state_dtype == "float32" else 1e-2
        _assert_trees_close(tp, jp, UPDATE_ATOL, f"{kind} params {step}")
        _assert_trees_close(ts, js, atol, f"{kind} state {step}")


@pytest.mark.parametrize("threshold", [None, 1 << 12])
def test_adafactor_matches_the_reference_on_a_stacked_model(threshold,
                                                            monkeypatch):
    """Adafactor on qwen3's smoke weights in the reference's stacked
    layout.  Its update-clipping RMS spans the whole layer stack below
    2^28 elements and one layer above (when the statistics align on the
    layer axis), and a stacked 2-D leaf (a norm's (L, d) scales) factors
    over the layers; a per-layer RMS everywhere would miss both.  With
    the threshold lowered to 2^12 both packages take the per-layer
    branch for the big stacks."""
    if threshold is not None:
        monkeypatch.setattr(jopt, "_CHUNK_THRESHOLD", threshold)
        monkeypatch.setattr(opt_mod, "_CHUNK_THRESHOLD", threshold)
    jcfg_m = jget_config("qwen3-1.7b").smoke()
    jparams = JModel(jcfg_m).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    jgrads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 0.01), jparams)
    cfg = OptConfig(kind="adafactor", lr=1e-2, warmup_steps=0,
                    total_steps=10)
    jo = jopt.make_optimizer(jopt.OptConfig(**cfg.__dict__))
    jp, js = jparams, jo.init(jparams)
    opt = make_optimizer(cfg)
    tp = {k: _t(v) for k, v in flatten(jax.tree.map(np.asarray,
                                                    jparams)).items()}
    ts = opt.init(tp)
    tg = {k: _t(v) for k, v in flatten(jax.tree.map(np.asarray,
                                                    jgrads)).items()}
    for step in range(2):
        tp, ts = opt.update(tg, ts, tp, step)
        jp, js = jo.update(jgrads, js, jp, step)
    _assert_trees_close(tp, jp, UPDATE_ATOL, "params")
    _assert_trees_close(ts["f"], js["f"], UPDATE_ATOL, "state")
    assert ts["f"]["layers.attn_norm.scale"]["vr"].shape == (2,)


def test_bf16_optimizer_state_dtype():
    cfg = OptConfig(kind="adamw", state_dtype="bfloat16")
    opt = make_optimizer(cfg)
    params = {"w": torch.ones((4, 4))}
    st = opt.init(params)
    assert st["m"]["w"].dtype == torch.bfloat16
    g = {"w": torch.ones((4, 4))}
    p2, st2 = opt.update(g, st, params, 0)
    assert p2["w"].dtype == params["w"].dtype
    assert st2["v"]["w"].dtype == torch.bfloat16


def test_grad_clip():
    g = {"a": torch.full((10,), 10.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    assert float(global_norm(clipped.values())) == pytest.approx(1.0,
                                                                 rel=1e-5)
    jclipped, jgn = jopt.clip_by_global_norm({"a": jnp.full((10,), 10.0)},
                                             1.0)
    assert float(gn) == float(jgn)
    np.testing.assert_array_equal(clipped["a"].numpy(),
                                  np.asarray(jclipped["a"]))
    bf = {"a": torch.full((10,), 10.0, dtype=torch.bfloat16)}
    assert clip_by_global_norm(bf, 1.0)[0]["a"].dtype == torch.bfloat16


def test_microbatch_accumulation_matches_full_batch():
    model, cfg = _smoke_model()
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                        weight_decay=0.0)
    state = init_train_state(model, opt_cfg)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=32, batch_size=8)
    batch = {k: torch.as_tensor(v) for k, v in stream.next().items()}

    s1, m1 = build_train_step(model, opt_cfg)(state, batch)
    s4, m4 = build_train_step(model, opt_cfg, n_microbatches=4)(state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-4)
    d = max(float((s1["params"][k] - s4["params"][k]).abs().max())
            for k in s1["params"])
    assert d < 5e-3                   # f32 accumulation-order noise
    assert s1["step"] == s4["step"] == 1 and state["step"] == 0


def test_loss_decreases_end_to_end():
    """The e2e sanity bar: a small LM learns the Markov corpus."""
    model, cfg = _smoke_model(seed=1)
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                        weight_decay=0.0)
    state = init_train_state(model, opt_cfg)
    step_fn = build_train_step(model, opt_cfg)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=32,
                         batch_size=8, markov_temp=0.3)
    losses = []
    for _ in range(40):
        state, m = step_fn(state, stream.next())
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), losses


def test_token_stream_determinism_and_resume():
    a = TokenStream(vocab_size=100, seq_len=16, batch_size=4, seed=7)
    b1 = [a.next() for _ in range(3)]
    st = a.state()
    b2 = a.next()
    resumed = TokenStream.from_state(st, vocab_size=100, seq_len=16,
                                     batch_size=4)
    b2r = resumed.next()
    np.testing.assert_array_equal(b2["tokens"], b2r["tokens"])
    fresh = TokenStream(vocab_size=100, seq_len=16, batch_size=4, seed=7)
    np.testing.assert_array_equal(b1[0]["tokens"], fresh.next()["tokens"])


def test_token_stream_shards_are_disjoint_and_cover():
    s0 = TokenStream(vocab_size=50, seq_len=8, batch_size=8, seed=3,
                     n_shards=2, shard=0)
    s1 = TokenStream(vocab_size=50, seq_len=8, batch_size=8, seed=3,
                     n_shards=2, shard=1)
    b0, b1 = s0.next(), s1.next()
    assert b0["tokens"].shape == (4, 8)
    assert not np.array_equal(b0["tokens"], b1["tokens"])


@pytest.mark.parametrize("kw", [
    dict(vocab_size=100, seq_len=16, batch_size=4, seed=7),
    dict(vocab_size=512, seq_len=32, batch_size=8, markov_temp=0.3),
    dict(vocab_size=50, seq_len=8, batch_size=8, seed=3, n_shards=2,
         shard=1, step=5)])
def test_token_stream_batches_equal_the_reference(kw):
    a, b = TokenStream(**kw), JTokenStream(**kw)
    for _ in range(3):
        x, y = a.next(), b.next()
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    assert a.state() == b.state()


@pytest.mark.parametrize("shape", [(9, 4, 5), (1, 3, 7), (50,)])
def test_updates_in_slices_equal_the_whole(shape, monkeypatch):
    """A leaf above the chunk threshold is updated a slice at a time
    (a row larger than the threshold split again): the same numbers."""
    rng = np.random.default_rng(6)
    p = {"w": _t(rng.standard_normal(shape).astype(np.float32))}
    g = {"w": _t(rng.standard_normal(shape).astype(np.float32))}
    for kind in ("adamw", "sgdm"):
        opt = make_optimizer(OptConfig(kind=kind, lr=1e-2, warmup_steps=0))
        whole = opt.update(g, opt.init(p), p, 3)
        monkeypatch.setattr(opt_mod, "_CHUNK_THRESHOLD", 6)
        sliced = opt.update(g, opt.init(p), p, 3)
        monkeypatch.undo()
        assert torch.equal(whole[0]["w"], sliced[0]["w"])
        for name, t in whole[1].items():
            assert torch.equal(t["w"], sliced[1][name]["w"])
