"""The readers of the program's spans (`metrics/engine.host_ms.py`,
`filter.query_prep_ms.py`, `engine.syncs_per_batch.py`): their values
from a hand-made kernel profiler summary, None where a span, the span
table or the sync count is missing (a program without them, a run
without a card), and all three in a traced run on the host."""

import time

import pytest

from bench_h100 import harness, spec
from bench_h100.tests import tiny
from repro_torch.obs.profiler import Summary

READERS = ("engine.host_ms", "filter.query_prep_ms",
           "engine.syncs_per_batch")

KERNELS = {"l2_topk.knn": {"calls": 4, "total_s": 0.07, "total_bytes": 10}}


def _ctx(spans, kernels=KERNELS):
    ctx = harness.Context(cfg={}, traffic={}, shape={})
    ctx.kernels = Summary(kernels, spans)
    return ctx


FULL = {"engine.search_batch": {"calls": 4, "total_s": 0.040, "syncs": 20},
        "filter": {"calls": 4, "total_s": 0.030, "syncs": 4},
        "filter.query_prep": {"calls": 4, "total_s": 0.006, "syncs": 4},
        "refine": {"calls": 4, "total_s": 0.009, "syncs": 12},
        "engine.wait": {"calls": 12, "total_s": 0.028, "syncs": 12}}


def _read(name, ctx):
    return spec.part("metrics", name).read(ctx)


def test_readers_divide_by_the_batch_spans():
    ctx = _ctx(FULL)
    assert _read("engine.host_ms", ctx) == pytest.approx(3.0)
    assert _read("filter.query_prep_ms", ctx) == pytest.approx(1.5)
    assert _read("engine.syncs_per_batch", ctx) == 5.0


def test_readers_leave_the_kernel_table_alone():
    """Span names in the kernel table (device seconds) are not read."""
    ctx = _ctx({}, kernels={**KERNELS, **FULL})
    assert all(_read(name, ctx) is None for name in READERS)


@pytest.mark.parametrize("missing", ["engine.search_batch",
                                     "filter.query_prep", "engine.wait"])
def test_readers_give_none_without_their_spans(missing):
    ctx = _ctx({k: v for k, v in FULL.items() if k != missing})
    needs = {"engine.host_ms": {"engine.search_batch", "engine.wait"},
             "filter.query_prep_ms": {"engine.search_batch",
                                      "filter.query_prep"},
             "engine.syncs_per_batch": {"engine.search_batch"}}
    for name in READERS:
        got = _read(name, ctx)
        assert (got is None) == (missing in needs[name]), name


def test_syncs_give_none_where_nothing_counted_them():
    ctx = _ctx({k: {"calls": v["calls"], "total_s": v["total_s"]}
                for k, v in FULL.items()})
    assert _read("engine.syncs_per_batch", ctx) is None
    assert _read("engine.host_ms", ctx) == pytest.approx(3.0)


@pytest.mark.parametrize("kernels", [None, {}, dict(KERNELS), Summary(
    KERNELS, {"engine.search_batch": {"calls": 0, "total_s": 0.0,
                                      "syncs": 0}})])
def test_readers_give_none_without_a_timed_batch(kernels):
    ctx = harness.Context(cfg={}, traffic={}, shape={})
    ctx.kernels = kernels
    assert all(_read(name, ctx) is None for name in READERS)


def test_every_cell_reports_the_span_metrics_when_traced():
    for cell in tiny.CELLS:
        names = {m["name"] for m in spec.metrics_of(cell, True)}
        assert set(READERS) <= names


@pytest.mark.parametrize("name", tiny.CELLS[:2])
def test_traced_run_reads_the_spans(name):
    """On the host the spans are timed; no card, so no sync is counted
    and the line leaves `engine.syncs_per_batch` out."""
    out = harness.run(tiny.cell(name, trace=True), tiny.SEED, 0.3, True,
                      "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert "engine.syncs_per_batch" not in got
    assert 0 < got["filter.query_prep_ms"]["value"] \
        < got["engine.host_ms"]["value"]
