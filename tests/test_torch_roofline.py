"""The port's roofline (`repro_torch.launch.roofline`) against the
reference's (`repro.launch.roofline`): the analytic counts equal, cell
for cell; the terms differ only by the card's constants (and the two
kept differences: no link on one card, the fp32 peak for the scan
cells); the port forms of tests/test_roofline_model.py."""

import dataclasses
import os

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.model import n_active_params, n_params

TPU = {"peak": 197e12, "hbm": 819e9, "ici": 50e9}


@pytest.fixture(scope="module")
def ref():
    """The reference's roofline and dry-run modules.  Importing
    repro.launch.dryrun sets XLA_FLAGS for the process; the old value is
    put back so later subprocesses of this worker do not inherit it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.configs import get_config as ref_get_config
        from repro.launch import dryrun as ref_dryrun
        from repro.launch import roofline as ref_roofline
        from repro.models.config import SHAPES as REF_SHAPES
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return {"roofline": ref_roofline, "dryrun": ref_dryrun,
            "get_config": ref_get_config, "SHAPES": REF_SHAPES}


LM_CELLS = [c for c in dryrun.all_cells() if c[0] != "ppanns-scan"]
PROD = ("1pod_256", "2pod_512")


def _eq(a, b):
    assert a == pytest.approx(b, rel=1e-12), (a, b)


def test_constants_are_the_h100s():
    assert roofline.PEAK_BF16_FLOPS == 989e12
    assert roofline.PEAK_FP32_FLOPS == 67e12
    assert roofline.PEAK_INT8_OPS == 1979e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9
    assert roofline.MESHES["1card_h100"] == {"data": 1, "model": 1}


def test_settings_and_cells_equal_the_reference(ref):
    rd = ref["dryrun"]
    assert dryrun.TRAIN_SETTINGS == rd.TRAIN_SETTINGS
    assert dryrun.DEFAULT_TRAIN == rd.DEFAULT_TRAIN
    assert dryrun.PPANNS_CELLS == rd.PPANNS_CELLS
    assert dryrun.all_cells() == rd.all_cells()
    for arch, shape in dryrun.all_cells():
        if arch != "ppanns-scan":
            assert (dryrun.rules_for(shape, arch).table
                    == rd.rules_for(shape, arch).table)


@pytest.mark.parametrize("arch,shape", LM_CELLS)
def test_analytic_counts_equal_the_reference(ref, arch, shape):
    """(1) exec_flops, exec_bytes, exec_collectives on both production
    meshes and model_flops, every term, for every runnable cell."""
    rr = ref["roofline"]
    cfg, rcfg = get_config(arch), ref["get_config"](arch)
    sc, rsc = SHAPES[shape], ref["SHAPES"][shape]
    pairs = [(roofline.exec_flops(cfg, sc), rr.exec_flops(rcfg, rsc)),
             (roofline.exec_bytes(cfg, sc, arch),
              rr.exec_bytes(rcfg, rsc, arch))]
    for mesh in PROD:
        ms = roofline.MESHES[mesh]
        pairs.append((roofline.exec_collectives(cfg, sc, arch, ms),
                      rr.exec_collectives(rcfg, rsc, arch, ms)))
    for got, want in pairs:
        assert set(got) == set(want)
        for k in want:
            _eq(got[k], want[k])
    _eq(dryrun.model_flops(cfg, sc), ref["dryrun"].model_flops(rcfg, rsc))


@pytest.mark.parametrize("arch,shape", dryrun.all_cells())
def test_analyze_record_terms_are_the_references_over_the_cards_constants(
        ref, arch, shape):
    """(1) analyze_record on the same synthetic record: each term times
    its constant is the reference's term times the TPU's; on one card the
    collective term is 0 and the counts are whole."""
    rr = ref["roofline"]
    rec = {"arch": arch, "shape": shape, "ok": True, "model_flops": 1e15,
           "cost": {"flops": 1.0}}
    peak = (roofline.PEAK_FP32_FLOPS if arch == "ppanns-scan"
            else roofline.PEAK_BF16_FLOPS)
    for mesh in PROD:
        got = roofline.analyze_record(dict(rec, mesh=mesh))
        want = rr.analyze_record(dict(rec, mesh=mesh))
        assert got.chips == want.chips
        _eq(got.compute_s * peak, want.compute_s * TPU["peak"])
        _eq(got.memory_s * roofline.HBM_BW, want.memory_s * TPU["hbm"])
        _eq(got.collective_s * roofline.LINK_BW,
            want.collective_s * TPU["ici"])
        _eq(got.exec_flops_total, want.exec_flops_total)
        assert got.peak_flops == peak
    one = roofline.analyze_record(dict(rec, mesh="1card_h100"))
    want = rr.analyze_record(dict(rec, mesh="1pod_256"))
    assert one.chips == 1 and one.collective_s == 0.0
    _eq(one.compute_s * peak, want.compute_s * TPU["peak"] * 256)
    _eq(one.memory_s * roofline.HBM_BW, want.memory_s * TPU["hbm"] * 256)
    assert one.dominant in ("compute", "memory")


def test_failed_record_has_no_row():
    assert roofline.analyze_record({"arch": "qwen3-1.7b",
                                    "shape": "train_4k", "mesh": "1pod_256",
                                    "ok": False}) is None


def test_model_flops_definitions():
    """(2) tests/test_roofline_model.py:80 in the port: MoE's active
    parameters far below the total; 6 N_active D for train, 2 N_active B
    for decode."""
    cfg = get_config("kimi-k2-1t-a32b")
    n, n_act = n_params(cfg), n_active_params(cfg)
    assert n_act < 0.1 * n
    assert dryrun.model_flops(cfg, SHAPES["train_4k"]) == pytest.approx(
        6.0 * n_act * 256 * 4096, rel=1e-6)
    assert dryrun.model_flops(cfg, SHAPES["decode_32k"]) == pytest.approx(
        2.0 * n_act * 128, rel=1e-6)


HANDFUL = [("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "decode_32k"),
           ("kimi-k2-1t-a32b", "prefill_32k"), ("mamba2-370m", "long_500k"),
           ("whisper-small", "train_4k"), ("zamba2-1.2b", "decode_32k"),
           ("ppanns-scan", "scan_16m"), ("ppanns-scan", "scan_16m_gspmd")]


def test_roofline_terms_positive_and_dominant_valid(tmp_path):
    """(3) tests/test_roofline_model.py:97 in the port, over records this
    test writes (metas only on the production meshes; traced on one card
    for the cells that trace in seconds)."""
    for arch, shape in HANDFUL:
        for mesh in PROD:
            assert dryrun.run_cell(arch, shape, mesh, str(tmp_path),
                                   verbose=False)["ok"]
        traced = arch == "ppanns-scan" or shape == "decode_32k"
        assert dryrun.run_cell(arch, shape, "1card_h100", str(tmp_path),
                               verbose=False, trace=traced)["ok"]
    for mesh in (*PROD, "1card_h100"):
        rows = roofline.table(str(tmp_path), mesh_filter=mesh)
        assert len(rows) == len(HANDFUL)
        for r in rows:
            assert r.compute_s > 0 and r.memory_s > 0
            assert r.collective_s >= 0
            assert (r.collective_s == 0) == (mesh == "1card_h100")
            assert r.dominant in ("compute", "memory", "collective")
            assert 0 < r.fraction_of_roofline() <= 1.0 + 1e-9, r
            if r.arch != "ppanns-scan":
                assert 0 < r.useful_ratio <= 1.0, r
    text = roofline.format_table(roofline.table(str(tmp_path), "1card_h100"))
    assert "scan_16m_gspmd" in text and "qwen3-1.7b" in text


def test_exec_flops_matches_a_counted_trace():
    """(4) tests/test_roofline_model.py:57 in the port: the 1-layer fp32
    qwen3-1.7b train step (B 8 x S 512, sgdm, remat off) traced on meta;
    FlopCounterMode's count in place of XLA's, within the reference's
    0.5-2.0 bar, and the dry run's StepTrace counts exactly what
    FlopCounterMode counts."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import Model
    from repro_torch.models.model import batch_metas
    from repro_torch.training import (OptConfig, build_train_step,
                                      init_train_state)
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=1,
                              remat=False, dtype="float32")
    sc = ShapeConfig("t", "train", 512, 8)
    counts = []
    for mode in ("flop_counter", "step_trace"):
        model = Model(cfg, device="meta", seed=None)
        opt = OptConfig(kind="sgdm")
        state = init_train_state(model, opt)
        batch = {k: torch.empty(m.shape, dtype=getattr(torch, m.dtype),
                                device="meta")
                 for k, m in batch_metas(cfg, sc).items()}
        step = build_train_step(model, opt)
        counter = (FlopCounterMode(display=False) if mode == "flop_counter"
                   else dryrun.StepTrace())
        with counter:
            step(state, batch)
        counts.append(counter.get_total_flops() if mode == "flop_counter"
                      else counter.flops)
    assert counts[0] == counts[1] > 0
    ratio = roofline.exec_flops(cfg, sc)["total"] / counts[0]
    assert 0.5 < ratio < 2.0, (counts, ratio)
