"""The reader of `filter.sm_fill`: the work tiles over the slot tiles of
the fused scans' counters, None where the kernel profiler's summary has
no counters table (a program without it) or no launch counted."""

import pytest

from bench_h100 import harness, spec
from repro_torch.obs.profiler import Summary


def _read(kernels):
    ctx = harness.Context(cfg={}, traffic={}, shape={})
    ctx.kernels = kernels
    return spec.part("metrics", "filter.sm_fill").read(ctx)


def test_sm_fill_sums_the_fused_scans_counters():
    counters = {"l2_topk.knn": {"work_tiles": 62528, "slot_tiles": 64548},
                "adc_topk.sq_adc_topk": {"work_tiles": 10, "slot_tiles": 20}}
    got = _read(Summary({}, {}, counters))
    assert got == pytest.approx(100.0 * 62538 / 64568)
    one = _read(Summary({}, {}, {"l2_topk.knn": counters["l2_topk.knn"]}))
    assert one == pytest.approx(96.87, abs=0.01)


class _OldSummary(dict):
    """A kernel profiler summary with spans and no counters table."""
    spans = {}


@pytest.mark.parametrize("kernels", [None, {}, _OldSummary(),
                                     Summary({}, {}), Summary({}, {}, {})])
def test_sm_fill_is_none_without_counters(kernels):
    assert _read(kernels) is None


def test_every_cell_reports_sm_fill_when_traced():
    for w in spec.benchmark()["workloads"]:
        names = {m["name"] for m in spec.metrics_of(w["name"], True)}
        assert "filter.sm_fill" in names
