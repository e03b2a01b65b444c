"""The GIST1M cell on the host at its own width: d 960 uncut, 4,096
rows, batches of 32 from a pool of 64.  The program's answers are
`correct` against the reference, the faults of `test_h100bench_faults`
make them not correct, the reference equals a brute-force float64
answer, the control is not correct, and the work models give the counts
of the cell's shape on the card."""

import time

import numpy as np
import pytest
import torch

from bench_h100 import control, datagen, harness, peaks, reference, spec
from bench_h100.tests import tiny
from bench_h100.tests.test_h100bench_faults import (_answer_altered,
                                                     _half_batch)
from bench_h100.tests.test_h100bench_reference import _brute

CELL = "gist1m-flat.b1024-k10"
SECONDS = 0.3


def _cell(trace=False):
    return tiny.cell(CELL, trace, n=4096, d=960, batch=32, pool=64)


def _run(cell, patch=None, trace=False):
    return harness.run(cell, tiny.SEED, SECONDS, trace, "cpu",
                       time.perf_counter(), patch=patch)


def test_the_deployment_is_gist1m_uncut():
    w = spec.workload(CELL)
    cfg = spec.config(w["config"])
    entry, = (c for c in spec.benchmark()["configs"]
              if c["name"] == w["config"])
    assert entry["reduced"] == [] and w["chips"] == 1
    assert (cfg["n"], cfg["d"], cfg["dtype"]) == (1_000_000, 960, "float32")
    sift = spec.config("sift1m-flat")
    for key in ("data", "sap_s", "beta_fraction", "ratio_k", "engine",
                "refine_ratio", "filter", "layers"):
        assert cfg[key] == sift[key], key


def test_unbroken_path_is_correct():
    out = _run(_cell())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_traced_run_reports_the_per_layer_metrics():
    out = _run(_cell(trace=True), trace=True)
    assert out["correct"], out["checks"]
    assert {"owner.encrypt_rows_per_s", "engine.first_batch_s",
            "engine.refine_cmp_per_query", "filter_roofline",
            "refine_roofline"} <= set(out["metrics"])
    assert out["metrics"]["engine.refine_cmp_per_query"]["value"] == 80 * 79


@pytest.mark.parametrize("fault", [_answer_altered, _half_batch])
def test_broken_path_is_not_correct(fault):
    out = _run(_cell(), patch=fault)
    assert not out["correct"], out["checks"]


def test_reference_matches_brute_force():
    c = _cell()
    k = c.traffic["k"]
    sd = datagen.seeds(tiny.SEED)
    P, Q = (x.numpy() for x in datagen.mixture(c.cfg, 64, sd["data"],
                                               torch.device("cpu")))
    got, cand = reference.answers(c.cfg, k, P, Q, sd, "cpu")
    want, want_cand = _brute(c.cfg, k, P, Q, sd)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(cand, 1), np.sort(want_cand, 1))


def test_control_is_not_correct():
    out = control.control(_cell(), tiny.SEED, "cpu")
    assert not out["passes"], out


@pytest.mark.parametrize("work,kp,ops,nbytes", [
    # K1: 2*1024*1e6*960 + 2*(1024+1e6)*960 + 3*1024*1e6 operations;
    # 4*1024*960 + 4*1e6*960 + 12*1024*80 bytes: 29.42 ms at fp32's peak
    ("fp32_scan", 80, 1_971_073_966_080, 3_844_915_200),
    # K2 at D 1936: 4*1024*80^2*1936 + 2*1024*80*1936 + 1024*80^2
    # operations, 16*1024*80*1936 + 4*1024*1936 + 9*1024*80 + 8*1024*10
    # bytes: both bounds near 0.76 ms, the ridge
    ("dce_refine", 80, 51_074_826_240, 2_546_302_976),
])
def test_counts_at_the_cell_shape(work, kp, ops, nbytes):
    got = spec.part("work", work).count(nq=1024, n=1_000_000, d=960, kp=kp,
                                        k=10)
    assert got["ops"] == ops and got["bytes"] == nbytes
    assert peaks.bound_s(got["ops"], got["bytes"], got["peak"]) == \
        pytest.approx(max(ops / 67e12, nbytes / 3.35e12), rel=1e-12)
