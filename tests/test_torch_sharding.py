"""The port's sharding rules, meshes and int8 ring all-reduce
(`repro_torch.sharding`, `repro_torch.launch.mesh`) against
`repro.sharding` / `repro.launch.mesh`, on the CPU: the port forms of
tests/test_sharding.py's three resolve tests and of
`test_int8_ring_allreduce_subprocess` (the ring over 4 logical devices
against the reference's over 4 simulated XLA devices: bit-equal),
`train_state_pspecs` equal to the reference's, and the mesh as data.
`test_lower_compile_on_small_mesh` and `test_dryrun_artifacts_complete`
lower XLA programs and have no port form.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.sharding import rules as jrules
from repro.training import OptConfig as JOptConfig
from repro.training.train_loop import train_state_pspecs as jpspecs
from repro_torch.configs import get_config
from repro_torch.launch.mesh import (force_device_count, local_devices,
                                     make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import Model
from repro_torch.models.convert import flatten
from repro_torch.sharding.compression import (dequantize_int8,
                                              int8_ring_allreduce,
                                              make_int8_allreduce,
                                              quantize_int8)
from repro_torch.sharding.rules import (AxisRules, PURE_DP_TRAIN_RULES,
                                        SERVE_RULES, TRAIN_RULES,
                                        PartitionSpec as P, constrain,
                                        resolve_spec)
from repro_torch.training import OptConfig
from repro_torch.training.train_loop import train_state_pspecs

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, and torch's own thread pool in each would oversubscribe
    them (this file's small ops then spin for minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def test_resolve_divisibility_strict():
    mesh = _FakeMesh({"data": 16, "model": 16})
    # 40 heads don't divide 16 -> replicated under strict
    spec = resolve_spec(mesh, TRAIN_RULES, ("embed_fsdp", "heads"),
                        (5120, 40), strict=True)
    assert spec == P(None, None) or spec[1] is None
    # fused head dim 5120 divides -> sharded
    spec = resolve_spec(mesh, TRAIN_RULES, (None, "heads"),
                        (5120, 5120), strict=True)
    assert spec == P(None, "model")


def test_resolve_suffix_fallback():
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    # batch 256 < 512 -> falls back to ('data','model') = 256
    spec = resolve_spec(mesh, PURE_DP_TRAIN_RULES, ("act_batch", None),
                        (256, 64), strict=True)
    assert spec == P(("data", "model"), None)
    # batch 512 uses the full tuple
    spec = resolve_spec(mesh, PURE_DP_TRAIN_RULES, ("act_batch", None),
                        (512, 64), strict=True)
    assert spec == P(("pod", "data", "model"), None)


def test_resolve_no_axis_reuse():
    mesh = _FakeMesh({"data": 4, "model": 4})
    rules = AxisRules({"a": ("model",), "b": ("model",)})
    spec = resolve_spec(mesh, rules, ("a", "b"), (16, 16), strict=True)
    assert spec == P("model", None)        # model used once only


def _same_spec(got, want):
    return tuple(got) == tuple(want)


@pytest.mark.parametrize("strict", [True, False])
def test_resolve_equals_the_reference(strict):
    rng = np.random.default_rng(0)
    names = [None, "act_batch", "heads", "kv", "embed_fsdp", "vocab",
             "cache_seq", "ff"]
    for shape in ({"data": 16, "model": 16},
                  {"pod": 2, "data": 16, "model": 16}, {"data": 4}):
        mesh = _FakeMesh(shape)
        for _ in range(60):
            r = int(rng.integers(1, 4))
            axes = tuple(names[i] for i in rng.integers(0, len(names), r))
            dims = tuple(int(d) for d in rng.choice(
                [1, 3, 8, 40, 256, 512, 5120], r))
            for mine, ref in ((TRAIN_RULES, jrules.TRAIN_RULES),
                              (SERVE_RULES, jrules.SERVE_RULES),
                              (PURE_DP_TRAIN_RULES,
                               jrules.PURE_DP_TRAIN_RULES)):
                got = resolve_spec(mesh, mine, axes, dims, strict=strict)
                want = jrules.resolve_spec(mesh, ref, axes, dims,
                                           strict=strict)
                assert _same_spec(got, want), (shape, axes, dims)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "kimi-k2-1t-a32b",
                                  "zamba2-1.2b", "whisper-small",
                                  "nemotron-4-340b"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgdm"])
def test_train_state_pspecs_equal_the_reference(arch, kind):
    """At full width (the port's model on the `meta` device: no
    storage), ZeRO-1 on, over the 16 x 16 production mesh's shape."""
    mesh = _FakeMesh({"data": 16, "model": 16})
    model = Model(get_config(arch), device="meta", seed=None)
    got = train_state_pspecs(model, OptConfig(kind=kind), mesh,
                             TRAIN_RULES, zero1=True)
    want = jpspecs(JModel(jget_config(arch)), JOptConfig(kind=kind), mesh,
                   jrules.TRAIN_RULES, zero1=True)
    is_spec = lambda s: type(s).__name__ == "PartitionSpec"   # noqa: E731
    want = jax.tree_util.tree_flatten_with_path(want, is_leaf=is_spec)[0]
    want = {".".join(str(k.key) for k in path): s for path, s in want}
    got = {f"{part}.{k}": v for part in ("params", "opt")
           for k, v in flatten(got[part]).items()} | {"step": got["step"]}
    assert set(got) == set(want)
    for k, s in want.items():
        assert _same_spec(got[k], s), (k, got[k], s)
    assert any("data" in tuple(s) for k, s in got.items()
               if k.startswith("opt."))


def test_constrain_checks_and_returns_its_input():
    mesh = _FakeMesh({"data": 4, "model": 2})
    x = torch.ones(8, 6)
    assert constrain(x, mesh, TRAIN_RULES, "act_batch", "act_heads") is x
    assert constrain(x, None, TRAIN_RULES) is x
    with pytest.raises(ValueError):
        constrain(x, mesh, TRAIN_RULES, "act_batch")


def test_meshes_as_data():
    with pytest.raises(ValueError, match="256 devices"):
        make_production_mesh(device="cpu")
    assert make_host_mesh("cpu").shape == {"data": 1}
    force_device_count(512)
    try:
        mesh = make_production_mesh(device="cpu")
        assert mesh.shape == {"data": 16, "model": 16} and mesh.size == 256
        pod = make_production_mesh(multi_pod=True, device="cpu")
        assert pod.shape == {"pod": 2, "data": 16, "model": 16}
        for i in (0, 1, 17, 300, 511):
            want = np.unravel_index(i, (2, 16, 16))
            assert tuple(pod.coords(i).values()) == tuple(int(w)
                                                          for w in want)
        assert make_host_mesh("cpu").shape == {"data": 512}
    finally:
        force_device_count(None)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_quantize_matches_the_reference(seed):
    """Against the reference op by op (a true division of amax by 127,
    as its ring computes it: test_int8_ring_allreduce_equals_the_
    reference).  `jax.jit(quantize_int8)` alone folds that division into
    a product with the float32 reciprocal, whose scale differs by an ulp
    for some inputs (seed 1 here)."""
    from repro.sharding import compression as jc
    rng = np.random.default_rng(0)
    for _ in range(seed):
        x = (rng.standard_normal(1 << 20)
             * rng.uniform(0.1, 10)).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jc.quantize_int8(jax.numpy.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, js)))


_SUBPROC = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import functools
    import jax, numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.sharding.compression import int8_ring_allreduce
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((4,), ("data",))
    ring = shard_map(functools.partial(
        int8_ring_allreduce, axis_name="data"), mesh=mesh,
        in_specs=P("data", None), out_specs=P("data", None),
        check_rep=False)
    for name in sys.argv[1:]:
        x = np.load(name + ".in.npy")
        np.save(name + ".out.npy", np.asarray(ring(jax.numpy.asarray(x))))
    print("RESULT:ok")
""")


def _ring_inputs():
    rng = np.random.default_rng(5)
    return {"arange": np.arange(4 * 103, dtype=np.float32).reshape(4, 103)
            / 7.0,
            "normal": rng.standard_normal((4, 1000)).astype(np.float32),
            "large": rng.standard_normal((4, 1 << 18)).astype(np.float32),
            "scales": (rng.standard_normal((4, 37))
                       * np.array([[1e-3], [1.0], [30.0], [0.5]]))
            .astype(np.float32)}


def test_int8_ring_allreduce_equals_the_reference(tmp_path):
    """4 logical CPU devices against the reference's ring over 4
    simulated XLA devices (a subprocess: jax pins the device count at
    its first use): every rank's result bit-equal."""
    inputs = _ring_inputs()
    for name, x in inputs.items():
        np.save(tmp_path / f"{name}.in.npy", x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _SUBPROC,
                          *(str(tmp_path / n) for n in inputs)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RESULT:ok" in out.stdout
    force_device_count(4)
    try:
        devices = local_devices("cpu")
        for name, x in inputs.items():
            want = np.load(tmp_path / f"{name}.out.npy")
            got = int8_ring_allreduce([torch.from_numpy(x[r:r + 1]).to(d)
                                       for r, d in enumerate(devices)])
            np.testing.assert_array_equal(
                np.concatenate([g.numpy() for g in got]), want,
                err_msg=name)
            exact = x.sum(0, keepdims=True).repeat(4, 0)
            err = np.abs(want - exact).max() / (np.abs(exact).max() + 1e-9)
            assert err < 0.02, (name, err)
    finally:
        force_device_count(None)


def test_int8_ring_over_a_tree():
    force_device_count(3)
    try:
        mesh = make_mesh((3,), ("data",), device="cpu")
        sync = make_int8_allreduce(mesh, "data")
        rng = np.random.default_rng(2)
        tree = {"a": [torch.from_numpy(rng.standard_normal((5, 4))
                                       .astype(np.float32))
                      for _ in range(3)],
                "b": {"c": [torch.full((7,), float(i)) for i in range(3)]}}
        out = sync(tree)
        for leaf, got in ((tree["a"], out["a"]),
                          (tree["b"]["c"], out["b"]["c"])):
            want = sum(leaf)
            for g in got:
                assert g.shape == want.shape
                torch.testing.assert_close(g, want, rtol=0, atol=0.02 * float(
                    want.abs().max()))
        with pytest.raises(ValueError):
            sync({"a": [torch.ones(2)]})
        assert int8_ring_allreduce([torch.ones(3)])[0].tolist() == [1.0] * 3
    finally:
        force_device_count(None)
    assert json.dumps(mesh.shape) == '{"data": 3}'
