"""The port's checkpoints (`repro_torch.checkpoint`) against
`repro.checkpoint`, on the CPU: the port forms of the four checkpoint
tests of tests/test_checkpoint_ft.py (the three runner tests were
ported with the resilience slice), and the layout itself: the same
train state saved by both packages gives the same manifest and the same
`.npy` bytes, float32 and bfloat16 leaves alike, and each package
restores the other's float32 checkpoint.

One divergence is kept on purpose and pinned here: the reference cannot
restore its own bfloat16 leaf (`np.load` gives a `<V2` array and
`jnp.asarray` of it raises TypeError); the port restores it through the
manifest's dtype.
"""

import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jget_config
from repro.data.loader import TokenStream
from repro.models import Model as JModel
from repro.training import OptConfig as JOptConfig
from repro.training import build_train_step as jbuild_train_step
from repro.training import init_train_state as jinit_train_state
from repro_torch.checkpoint import (cleanup_old, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.launch.mesh import force_device_count, make_mesh
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.training.train_loop import state_from_tree, state_tree

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, and torch's own thread pool in each would oversubscribe
    them (this file's small ops then spin for minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((8, 8))
                                  .astype(np.float32)),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    assert latest_step(str(tmp_path)) == 3
    r, manifest = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert manifest["step"] == 3
    for a, b in zip(_leaves(t), _leaves(r)):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_crash_mid_save_leaves_no_corrupt_checkpoint(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    # simulate a crash: a stale tmp dir with partial contents
    tmp_dir = tmp_path / "step_00000002.tmp-9999"
    tmp_dir.mkdir()
    (tmp_dir / "arr_00000.npy").write_bytes(b"partial")
    assert latest_step(str(tmp_path)) == 1          # tmp dirs are invisible
    r, m = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert m["step"] == 1
    cleanup_old(str(tmp_path), keep=3)
    assert not tmp_dir.exists()


def test_cleanup_keeps_newest(tmp_path):
    t = _tree()
    for s in [1, 2, 3, 4]:
        save_checkpoint(str(tmp_path), s, t)
    cleanup_old(str(tmp_path), keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]


@pytest.mark.parametrize("n,shape,axes,spec", [
    (1, (1,), ("data",), P("data", None)),
    (4, (4,), ("data",), P("data", None)),
    (4, (2, 2), ("data", "model"), P("data", "model")),
    (4, (2, 2), ("data", "model"), P(None, ("data", "model")))])
def test_elastic_restore_onto_mesh(tmp_path, n, shape, axes, spec):
    """Restore places each leaf by its spec over the restoring mesh (one
    block a logical device) — the same path covers scale-up/down."""
    t = {"w": torch.arange(16.0).reshape(4, 4), "s": torch.tensor(2)}
    save_checkpoint(str(tmp_path), 1, t, mesh=None)
    force_device_count(n)
    try:
        mesh = make_mesh(shape, axes, device="cpu")
        r, _ = restore_checkpoint(str(tmp_path), t, mesh=mesh,
                                  pspecs={"w": spec, "s": None},
                                  device="cpu")
    finally:
        force_device_count(None)
    blocks = r["w"]
    assert len(blocks) == mesh.size
    for i, blk in enumerate(blocks):
        c = mesh.coords(i)
        rows = cols = slice(None)
        if spec == P("data", None):
            rows = slice(c["data"] * 4 // mesh.shape["data"],
                         (c["data"] + 1) * 4 // mesh.shape["data"])
        elif spec == P("data", "model"):
            rows = slice(2 * c["data"], 2 * c["data"] + 2)
            cols = slice(2 * c["model"], 2 * c["model"] + 2)
        else:
            j = c["data"] * 2 + c["model"]
            cols = slice(j, j + 1)
        torch.testing.assert_close(blk, t["w"][rows, cols], rtol=0, atol=0)
    assert int(r["s"]) == 2


# ----------------------------------------------- against the reference

def _reference_state(dtype: str, kind: str = "adamw"):
    """A reference train state of qwen3's smoke model after one step."""
    cfg = dataclasses.replace(jget_config("qwen3-1.7b").smoke(), dtype=dtype)
    model = JModel(cfg)
    opt = JOptConfig(kind=kind, lr=1e-3, warmup_steps=0, total_steps=10,
                     state_dtype=dtype)
    state = jinit_train_state(model, opt, jax.random.PRNGKey(0))
    batch = TokenStream(vocab_size=cfg.vocab_size, seq_len=16,
                        batch_size=2).next()
    state, _ = jax.jit(jbuild_train_step(model, opt))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_state(jstate):
    """The same state as the port holds it (tensors, flat paths)."""
    return state_from_tree(jax.tree.map(_to_torch, jstate))


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert "manifest.json" in names and len(names) > 20
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.mark.parametrize("dtype,kind", [("float32", "adamw"),
                                        ("bfloat16", "adamw"),
                                        ("float32", "adafactor")])
def test_same_state_same_files(tmp_path, dtype, kind):
    jstate = _reference_state(dtype, kind)
    ja = jsave(str(tmp_path / "jax"), 7, jstate, extra={"arch": "q"})
    pa = save_checkpoint(str(tmp_path / "port"), 7,
                         state_tree(_port_state(jstate)),
                         extra={"arch": "q"})
    _same_files(ja, pa)
    with open(os.path.join(pa, "manifest.json")) as f:
        entries = json.load(f)["entries"]
    assert entries[0]["key"].startswith("['opt']")
    assert entries[-1]["key"] == "['step']"
    wq = next(e for e in entries
              if e["key"] == "['params']['layers']['attn']['wq']")
    assert wq["shape"][0] == 2 and wq["dtype"] == dtype
    if dtype == "bfloat16":
        with open(os.path.join(pa, wq["file"]), "rb") as f:
            assert b"'descr': '<V2'" in f.read(128)


def test_each_package_restores_the_others_float32_checkpoint(tmp_path):
    jstate = _reference_state("float32")
    pstate = _port_state(jstate)
    jsave(str(tmp_path / "jax"), 3, jstate)
    save_checkpoint(str(tmp_path / "port"), 3, state_tree(pstate))

    got, m = restore_checkpoint(str(tmp_path / "jax"), state_tree(pstate),
                                device="cpu")
    assert m["step"] == 3
    got = state_from_tree(got)
    assert got["step"] == pstate["step"] == 1
    for k, v in pstate["params"].items():
        torch.testing.assert_close(got["params"][k], v, rtol=0, atol=0)
    for part in ("m", "v"):
        for k, v in pstate["opt"][part].items():
            torch.testing.assert_close(got["opt"][part][k], v, rtol=0,
                                       atol=0)

    back, _ = jrestore(str(tmp_path / "port"), jstate)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: a.dtype == b.dtype and bool(jnp.array_equal(a, b)),
        back, jstate))


def test_bfloat16_restore_divergence_is_pinned(tmp_path):
    """The reference's restore of its own bf16 checkpoint raises; the
    port restores the same files bit for bit."""
    jstate = _reference_state("bfloat16")
    path = str(tmp_path / "jax")
    jsave(path, 1, jstate)
    with pytest.raises(TypeError):
        jrestore(path, jstate)
    pstate = _port_state(jstate)
    got, _ = restore_checkpoint(path, state_tree(pstate), device="cpu")
    got = state_from_tree(got)
    for k, v in pstate["params"].items():
        assert got["params"][k].dtype == torch.bfloat16
        assert torch.equal(got["params"][k].view(torch.int16),
                           v.view(torch.int16)), k
