"""The harness driven on the host with the timed path broken underneath:
`correct` must come out false for each fault a search cell can have, and
true for the unbroken path.  The look for a card is `run.py`'s; these
tests call the harness with device "cpu" at a tiny size."""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench_h100 import harness, spec
from bench_h100.tests import tiny

SECONDS = 0.3


def _run(cell, patch=None, trace=False):
    return harness.run(cell, tiny.SEED, SECONDS, trace, "cpu",
                       time.perf_counter(), patch=patch)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_unbroken_path_is_correct(name):
    out = _run(tiny.cell(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-2:] == ["explain", "checks"]
    assert set(out["metrics"]) == {m["name"] for m in spec.metrics_of(
        name, False)} - {"device_bytes_per_vector"}     # no card here


def test_traced_run_reports_the_per_layer_metrics():
    name = tiny.CELLS[0]
    out = _run(tiny.cell(name, trace=True), trace=True)
    assert out["correct"], out["checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert {"owner.encrypt_rows_per_s", "engine.first_batch_s",
            "engine.refine_cmp_per_query", "filter_roofline",
            "refine_roofline"} <= set(out["metrics"])
    assert out["metrics"]["engine.refine_cmp_per_query"]["value"] == 80 * 79


def _answer_altered(engine):
    """The refine's first answer of each batch names a wrong row."""
    search = engine.search_batch

    def broken(*a, **kw):
        ids, stats = search(*a, **kw)
        ids = ids.copy()
        ids[0] = (ids[0] + 1) % engine.n
        return ids, stats
    engine.search_batch = broken


def _half_batch(engine):
    """The second half of each batch is left out and answered with the
    first half's ids."""
    search = engine.search_batch

    def broken(Q, T, k, **kw):
        h = Q.shape[0] // 2
        ids, stats = search(Q[:h], T[:h], k, **kw)
        return np.concatenate([ids, ids]), stats
    engine.search_batch = broken


def _state_unchanged(engine):
    """Each batch returns the previous batch's answers."""
    search = engine.search_batch
    last = []

    def broken(*a, **kw):
        ids, stats = search(*a, **kw)
        out = last[0] if last else ids
        last[:] = [ids]
        return out, stats
    engine.search_batch = broken


@pytest.mark.parametrize("fault", [_answer_altered, _half_batch,
                                   _state_unchanged])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_broken_path_is_not_correct(fault, name):
    out = _run(tiny.cell(name, batch=16, pool=64), patch=fault)
    assert not out["correct"], out["checks"]


def test_no_jax_and_a_reference_without_the_program():
    """A whole run loads neither JAX nor the JAX package (whole top-level
    names: repro_torch is not repro), and the reference, the control and
    the comparison load nothing of the program."""
    script = (
        "import sys, time\n"
        "from bench_h100 import compare, control, reference, spec\n"
        "from bench_h100.tests import tiny\n"
        "for n in ('flat', 'sq8'): spec.part('filters', n)\n"
        "assert not any(m.partition('.')[0] == 'repro_torch' "
        "for m in sys.modules), 'reference loads the program'\n"
        "from bench_h100 import harness\n"
        "harness.run(tiny.cell(tiny.CELLS[1]), 1, 0.2, False, 'cpu', "
        "time.perf_counter())\n"
        "top = {m.partition('.')[0] for m in sys.modules}\n"
        "assert 'repro_torch' in top\n"
        "bad = top & {'jax', 'jaxlib', 'flax', 'repro'}\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=_env())
    assert res.returncode == 0, res.stderr[-3000:]


def _env():
    import os
    env = dict(os.environ)
    src = str(spec.ROOT / "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(spec.ROOT), src] + ([env["PYTHONPATH"]]
                                 if env.get("PYTHONPATH") else []))
    return env


@pytest.mark.cuda
def test_run_on_the_card():
    """run.py end to end on the card: a result line, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", tiny.CELLS[0],
         "--seed", str(tiny.SEED), "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    import json
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
