"""The port's dry run (`repro_torch.launch.dryrun`): per-device argument
bytes against the reference's metas and specs, every cell green on the
three meshes, the meta trace (`StepTrace`) against FlopCounterMode and
against the tensors a real step allocates, and the kernels' meta
branches."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.dce_comp import dce_comp
from repro_torch.kernels.l2_topk import l2_topk
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import device_count
from repro_torch.models import Model
from repro_torch.models.config import ShapeConfig
from repro_torch.training import OptConfig, init_train_state

ROOT = Path(__file__).resolve().parents[1]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _shard(shape, itemsize, spec, mesh) -> int:
    parts = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    n = 1
    for dim, p in zip(shape, parts):
        names = () if not p else ((p,) if isinstance(p, str) else p)
        n *= dim // int(np.prod([mesh.shape[a] for a in names]))
    return n * itemsize


def _ref_bytes(specs, values, mesh) -> int:
    """Per-device bytes of the reference's abstract values (or metas)
    placed by its specs."""
    from jax.sharding import PartitionSpec as P
    sizes = jax.tree.map(
        lambda sp, v: _shard(tuple(v.shape), jnp.dtype(v.dtype).itemsize,
                             sp, mesh),
        specs, values, is_leaf=lambda s: isinstance(s, P))
    return int(sum(jax.tree.leaves(sizes)))


def _ref_rules(shape: str, arch: str):
    """The reference's `rules_for` (repro/launch/dryrun.py:157)."""
    from repro.sharding import rules as R
    if shape == "train_4k":
        ts = dryrun.TRAIN_SETTINGS.get(arch, dryrun.DEFAULT_TRAIN)
        return R.PURE_DP_TRAIN_RULES if ts.get("pure_dp") else R.TRAIN_RULES
    if shape == "long_500k":
        return R.LONG_DECODE_RULES
    return R.SERVE_RULES


def _ref_argument_bytes(arch: str, shape: str, mesh) -> int:
    """The reference's step arguments by its metas and specs, without
    the int32 step / write-position scalars (host ints in the port)."""
    from repro.configs import get_config as ref_config
    from repro.models import Model as RefModel
    from repro.models.config import SHAPES as REF_SHAPES
    from repro.models.model import (batch_metas, batch_pspecs, cache_metas,
                                    cache_pspecs)
    from repro.training import OptConfig as RefOpt
    from repro.training import abstract_train_state
    from repro.training.train_loop import train_state_pspecs
    cfg, sc = ref_config(arch), REF_SHAPES[shape]
    model = RefModel(cfg)
    rules = _ref_rules(shape, arch)
    total = _ref_bytes(batch_pspecs(cfg, sc, mesh, rules),
                       batch_metas(cfg, sc), mesh)
    if sc.kind == "train":
        ts = dryrun.TRAIN_SETTINGS.get(arch, dryrun.DEFAULT_TRAIN)
        opt = RefOpt(kind=ts["opt"], state_dtype=ts["state_dtype"])
        st = abstract_train_state(model, opt)
        sp = train_state_pspecs(model, opt, mesh, rules,
                                zero1=bool(ts.get("zero1")))
        return total + sum(_ref_bytes(sp[k], st[k], mesh)
                           for k in ("params", "opt"))
    B, T = sc.global_batch, sc.seq_len
    cm, cs = cache_metas(cfg, B, T), cache_pspecs(cfg, B, T, mesh, rules)
    cm.pop("pos"), cs.pop("pos")
    return (total + _ref_bytes(model.param_specs(mesh, rules),
                               model.abstract_params(), mesh)
            + _ref_bytes(cs, cm, mesh))


@pytest.mark.parametrize("mesh_name", ["1pod_256", "2pod_512"])
def test_argument_bytes_per_device_equal_the_references(mesh_name):
    """(5) every cell's per-device argument bytes on 16 x 16 and
    2 x 16 x 16: the port's metas through the port's specs against the
    reference's metas through the reference's (ZeRO-1, pure DP, the
    cache specs, the scan's row split)."""
    from repro.serving.secure_scan import (secure_scan_input_specs,
                                           secure_scan_pspecs)
    mesh = _FakeMesh(roofline.MESHES[mesh_name])
    for arch, shape in dryrun.all_cells():
        rec = dryrun.cell_record(arch, shape, mesh_name)
        assert rec["ok"], rec.get("error")
        got = rec["memory"]["argument_bytes"]
        if arch == "ppanns-scan":
            c = dryrun.PPANNS_CELLS[shape]
            specs = secure_scan_input_specs(
                c["n"], c["d"], c["batch"],
                dtype=jnp.dtype(c.get("dtype", "float32")))
            want = _ref_bytes(secure_scan_pspecs(mesh), specs, mesh)
        else:
            want = _ref_argument_bytes(arch, shape, mesh)
        assert got == want, (arch, shape, got, want)
    assert device_count("cpu") == 1          # the forced count was reset


def test_dryrun_artifacts_complete(tmp_path):
    """(6) tests/test_sharding.py:133 in the port: every cell of
    all_cells() has an ok record on all three meshes (metas only)."""
    for arch, shape in dryrun.all_cells():
        for mesh in dryrun.MESH_NAMES:
            dryrun.run_cell(arch, shape, mesh, str(tmp_path),
                            verbose=False, trace=False)
    missing, failed = [], []
    for arch, shape in dryrun.all_cells():
        for mesh in dryrun.MESH_NAMES:
            fn = tmp_path / f"{arch}__{shape}__{mesh}.json"
            if not fn.exists():
                missing.append((arch, shape, mesh))
            elif not json.loads(fn.read_text()).get("ok"):
                failed.append((arch, shape, mesh))
    assert not missing, f"missing cells: {missing[:10]}"
    assert not failed, f"failed cells: {failed[:10]}"


def test_a_failing_cell_is_recorded_not_dropped(tmp_path):
    rec = dryrun.run_cell("qwen3-1.7b", "no_such_shape", "1card_h100",
                          str(tmp_path), verbose=False)
    assert rec["ok"] is False and "KeyError" in rec["error"]
    assert (tmp_path / "qwen3-1.7b__no_such_shape__1card_h100.json").exists()


def test_step_trace_counts_live_bytes_and_frees():
    """Live bytes rise by each new storage (512-byte blocks), fall when
    its last tensor or view dies, and views and in-place results add
    nothing."""
    a = torch.empty(1000, device="meta")                 # 4000 -> 4096
    tr = dryrun.StepTrace([a])
    with tr:
        b = a * 2                                         # +4096
        v = b.view(10, 100)                               # view: +0
        del b
        c = v + 1                                         # +4096
        c.add_(1)                                         # in place: +0
        del v                                             # frees b's
        d = torch.empty(100, device="meta")               # +512
    assert tr.peak == 3 * 4096
    assert tr.live == 4096 + 4096 + 512
    del c, d
    assert tr.live == 4096


def test_step_trace_remembers_results_by_the_whole_signature():
    """A remembered op result is reused only for the same op on the same
    shapes, strides, dtypes and typed arguments: a transposed input and
    an int times 2 against 2.0 get their own results, as meta gives."""
    x = torch.empty(4, 6, device="meta")
    xi = torch.empty(4, 6, dtype=torch.int32, device="meta")
    y = torch.empty(6, 4, device="meta")

    def ops():
        return [x.t() * 2, y * 2, xi * 2, xi * 2.0, xi * True,
                torch.sum(x, 0), torch.sum(x, 1), x.t().mm(x), y.mm(x)]
    want = [(t.shape, t.stride(), t.dtype) for t in ops()]
    tr = dryrun.StepTrace()
    with tr:
        ops()
        got = [(t.shape, t.stride(), t.dtype) for t in ops()]
    assert got == want
    assert tr.flops == 2 * (2 * 2 * 6 * 4 * 6)    # two mm (6,4)x(4,6), twice


SMOKE = ("qwen3-1.7b", "kimi-k2-1t-a32b", "mamba2-370m", "zamba2-1.2b",
         "whisper-small", "paligemma-3b")


def _batch(cfg, sc, device, gen=None):
    from repro_torch.models.model import batch_metas
    out = {}
    for k, m in batch_metas(cfg, sc).items():
        dt = getattr(torch, m.dtype)
        if device == "meta":
            out[k] = torch.empty(m.shape, dtype=dt, device="meta")
        elif dt == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, m.shape, generator=gen,
                                   dtype=torch.int32)
        else:
            out[k] = torch.randn(m.shape, generator=gen).to(dt)
    return out


@pytest.mark.parametrize("arch", SMOKE)
def test_step_trace_equals_flop_counter_and_the_real_step(arch):
    """At smoke width: the trace's FLOPs equal FlopCounterMode's on the
    same step (train with 2 microbatches, prefill, decode), and the
    traced outputs have the shapes, strides and dtypes of a real run on
    the host: the op cache makes what the meta functions make."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.training import build_train_step
    cfg = get_config(arch).smoke()
    gen = torch.Generator().manual_seed(0)
    sc_t = ShapeConfig("t", "train", 64, 4)
    sc_p = ShapeConfig("p", "prefill", 32, 2)
    results = {}
    for device in ("meta", "cpu"):
        model = Model(cfg, device=device, seed=None if device == "meta"
                      else 0)
        opt = OptConfig()
        runs = {}
        state = init_train_state(model, opt)
        step = build_train_step(model, opt, n_microbatches=2)
        runs["train"] = lambda: step(state, _batch(cfg, sc_t, device, gen))
        pb = _batch(cfg, sc_p, device, gen)
        cache = model.init_cache(2, 40)
        runs["prefill"] = lambda: model.prefill(pb, cache)
        tok = pb["tokens"][:, :1]
        runs["decode"] = lambda: model.decode_step(tok, dict(cache, pos=32))
        for name, run in runs.items():
            if device == "meta":
                fc = FlopCounterMode(display=False)
                with fc:
                    run()
                tr = dryrun.StepTrace()
                with tr:
                    out = run()
                assert tr.flops == fc.get_total_flops(), (name, arch)
                assert tr.peak > 0
            else:
                out = run()
            results[(device, name)] = [
                (tuple(t.shape), t.stride(), t.dtype)
                for t in jax.tree.leaves(out)
                if isinstance(t, torch.Tensor)]
    for name in ("train", "prefill", "decode"):
        assert results[("meta", name)] == results[("cpu", name)], name


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "grok-1-314b"])
def test_argument_bytes_equal_a_real_steps_tensors(arch):
    """The phase-11 (a) check rehearsed at smoke width: a cell record's
    argument bytes equal, to the byte, the tensors a real bf16 train
    step (adamw, fp32 moments, one microbatch) and decode step hold."""
    cfg = get_config(arch).smoke()
    gen = torch.Generator().manual_seed(0)
    sc_t = ShapeConfig("phase_train", "train", 64, 4)
    ts = dict(opt="adamw", state_dtype="float32", n_micro=1,
              accum="float32")
    rec = dryrun.cell_record(arch, "phase_train", "1card_h100", cfg=cfg,
                             sc=sc_t, train_settings=ts)
    assert rec["ok"], rec.get("error")
    model = Model(cfg, device="cpu", seed=0)
    state = init_train_state(model, OptConfig())
    held = [t for t in jax.tree.leaves(state) if isinstance(t, torch.Tensor)]
    held += list(_batch(cfg, sc_t, "cpu", gen).values())
    assert rec["memory"]["argument_bytes"] == sum(t.nbytes for t in held)
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"]

    sc_d = ShapeConfig("phase_decode", "decode", 48, 4)
    rec = dryrun.cell_record(arch, "phase_decode", "1card_h100", cfg=cfg,
                             sc=sc_d)
    assert rec["ok"], rec.get("error")
    model = Model(cfg, device="cpu", seed=0)
    cache = model.init_cache(4, 48)
    token = torch.zeros((4, 1), dtype=torch.int32)
    held = (list(model.parameters()) + [token]
            + [t for k, t in cache.items() if k != "pos"])
    assert rec["memory"]["argument_bytes"] == sum(t.nbytes for t in held)


def test_scan_16m_on_one_card():
    """The paper's cell on one card: 81,606,017,024 argument bytes (C_sap
    8.59e9 + C_dce 73.01e9 + the queries), traced through K1 and K2's
    meta branches over CARD_SHARDS logical shards, and it fits."""
    rec = dryrun.cell_record("ppanns-scan", "scan_16m", "1card_h100")
    assert rec["ok"], rec.get("error")
    mem = rec["memory"]
    assert mem["argument_bytes"] == 81_606_017_024
    assert mem["arguments"]["C_dce"] == 73_014_444_032
    assert 0 < mem["temp_bytes"] < 64 << 20
    assert rec["fits_one_card"] is True and rec["shards"] == dryrun.CARD_SHARDS
    assert rec["collectives"]["total"] == 0.0
    # the bf16 cells trace bf16 operands, read in place by K1 and K2:
    # half of scan_16m's argument bytes, no float32 copy in the peak
    for name, want in (("scan_16m_bf16", 40_803_008_512),
                       ("scan_16m_bf16_b4096", 40_805_466_112)):
        bf16 = dryrun.cell_record("ppanns-scan", name, "1card_h100")
        assert bf16["ok"] and bf16["cell_dtype"] == "bfloat16"
        assert bf16["operand_dtype"] == "bfloat16"
        assert bf16["memory"]["argument_bytes"] == want
        assert 0 < bf16["memory"]["temp_bytes"] < 128 << 20


def test_decode_32k_does_not_fit_one_card():
    rec = dryrun.cell_record("qwen3-1.7b", "decode_32k", "1card_h100")
    assert rec["ok"], rec.get("error")
    assert rec["fits_one_card"] is False
    assert rec["memory"]["argument_bytes"] > 481e9       # the KV cache
    assert rec["cost"]["flops"] > 0


def test_kernel_meta_branches_match_the_plain_shapes():
    """knn and refine_topk on meta tensors give the plain versions'
    shapes and dtypes, and launch nothing."""
    before = (dict(l2_topk.launches), dict(dce_comp.launches))
    g = torch.Generator().manual_seed(0)
    Q, X = torch.randn(5, 8, generator=g), torch.randn(300, 8, generator=g)
    for k in (7, 300, 1500, 0):
        want = l2_topk.knn(Q, X, k)
        got = l2_topk.knn(Q.to("meta"), X.to("meta"), k)
        assert [(t.shape, t.dtype) for t in got] == \
            [(t.shape, t.dtype) for t in want]
    C = torch.randn(50, 4, 24, generator=g)
    cand = torch.randint(0, 50, (3, 9), generator=g)
    T = torch.randn(3, 24, generator=g)
    want = dce_comp.refine_topk(C, cand, T, None, 4, return_wins=True)
    got = dce_comp.refine_topk(C.to("meta"), cand.to("meta"), T.to("meta"),
                               None, 4, return_wins=True)
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    with pytest.raises(TypeError):
        l2_topk.knn(Q.to("meta"), X.to("meta").int(), 3)
    assert (dict(l2_topk.launches), dict(dce_comp.launches)) == before


def test_cli_writes_one_record_a_mesh(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "ppanns-scan", "--shape", "scan_16m_gspmd", "--both-meshes",
         "--mesh", "1card_h100", "--out", str(tmp_path)],
        cwd=ROOT / "src", capture_output=True, text=True, timeout=300,
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin")})
    assert out.returncode == 0, out.stderr[-2000:]
    for mesh in dryrun.MESH_NAMES:
        rec = json.loads((tmp_path / f"ppanns-scan__scan_16m_gspmd__"
                                     f"{mesh}.json").read_text())
        assert rec["ok"] and rec["mesh"] == mesh
        assert (rec["memory"]["peak_bytes"] is None) == (mesh != "1card_h100")
