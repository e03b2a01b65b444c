"""The port's observability (`repro_torch.obs`): Prometheus exposition
equal to the JAX package's for the same record sequence, exact span
trees on VirtualClock for both schedulers, the `Observability` facade
and metrics endpoint, the kernel profiler, and disabled-mode no-op
guarantees (DESIGN.md §13) — the cases of tests/test_obs.py in port
form, on the CPU (`device="cpu"`).
"""

import json
import re
import threading
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.serving.runtime import CollectionTelemetry as JTelemetry
from repro.serving.runtime import VirtualClock as JVirtualClock
from repro.serving.search_engine import SearchStats as JSearchStats
from repro_torch.core import dcpe, ppanns
from repro_torch.data import synth
from repro_torch.kernels.dce_comp import ops as dce_ops
from repro_torch.kernels.l2_topk import ops as l2_ops
from repro_torch.obs import (NULL_RECORDER, MetricsRegistry, Observability,
                             TraceRecorder, child_span, current,
                             profile_kernels, start_metrics_server)
from repro_torch.obs import profiler as obs_profiler
from repro_torch.serving.runtime import (Collection, CollectionTelemetry,
                                         SlotLoop, VirtualClock)
from repro_torch.serving.search_engine import (SearchStats,
                                               SecureSearchEngine)

D = 24
K = 5
LABELS = {"tenant": "t", "collection": "c\"q\\"}    # escaping exercised


@pytest.fixture(scope="module")
def ds():
    return synth.make_dataset("sift1m", n=200, n_queries=4, d=D,
                              k_gt=K, seed=0)


# The engine's span tree of one batched call (DESIGN.md §13), and of
# the first call after the ciphertexts changed, which attaches them.
ENGINE_TREE = ("engine.search_batch", [
    ("filter", [("filter.query_prep", [])]),
    ("refine", [("engine.wait", [])] * 3)])
ATTACH_TREE = ("engine.attach", [("engine.upload", []),
                                 ("filter.attach", [])])
FIRST_ENGINE_TREE = (ENGINE_TREE[0], [ATTACH_TREE, *ENGINE_TREE[1]])


def _shape(node):
    """Span tree -> (name, [child shapes]) for exact assertions."""
    return (node["name"], [_shape(c) for c in node["children"]])


def _intervals(node):
    """Every (t_start, t_end) in a span tree."""
    out = {(node["t_start"], node["t_end"])}
    for c in node["children"]:
        out |= _intervals(c)
    return out


def _collection(ds, name, vc, rec, **kw):
    col = Collection("t", name, D,
                     sap_beta=dcpe.suggest_beta(ds.base, fraction=0.05),
                     seed=1, clock=vc, tracer=rec, device="cpu", **kw)
    col.insert(ds.base[:64])
    return col


# ----------------------------------------- exposition against the JAX one


def _record_sequence(tel, clock, stats_cls):
    """One fixed sequence of every record_* entry point."""
    def st(nq, **kw):
        return stats_cls(latency_s=0.0, filter_dist_evals=kw.get("d", 0),
                         refine_comparisons=kw.get("c", 0), bytes_up=3 * nq,
                         bytes_down=8 * nq, n_queries=nq, backend="flat",
                         filter_bytes_scanned=kw.get("s", 0),
                         n_dummy_queries=kw.get("dummies", 0),
                         n_hops=kw.get("h", 0),
                         n_edges_scanned=kw.get("e", 0),
                         degraded=kw.get("degraded", False))
    tel.record_submit(queue_depth=1)
    tel.record_submit(queue_depth=2)
    tel.record_reject()
    clock.advance(0.25)
    tel.record_flush(2, [0.0004, 0.03], st(2, d=100, c=50, s=4096),
                     queue_depth=0, shape=(2, D), n_dummies=0)
    clock.advance(0.5)
    tel.record_step(3, 8, [0.2, 0.7, 12.0], [0.1, 0.2, 0.3],
                    st(8, d=7, c=5, s=512, h=40, e=300, dummies=5),
                    queue_depth=4, shape=(8, D), n_dummies=5)
    tel.record_flush(1, [2.5], st(1, degraded=True), queue_depth=0,
                     shape=(1, D), n_dummies=0)
    tel.record_padded_bytes(64)
    tel.record_wal(3)
    tel.record_wal_replay(2)
    tel.record_checkpoint()
    tel.record_retry()
    tel.record_quarantine()
    tel.record_ingest(n_inserted=10)
    tel.record_ingest(n_deleted=2, compacted=True)


def test_metrics_text_equals_the_jax_package():
    """The same record sequence gives the same Prometheus exposition and
    snapshot.  The one HELP line that names what a recompile is (jitted
    executables there, kernel-library builds here) is the only
    difference; neither run recompiles, so no sample differs."""
    out = {}
    for name, tel_cls, reg_cls, clock_cls, stats_cls in (
            ("jax", JTelemetry, JMetricsRegistry, JVirtualClock,
             JSearchStats),
            ("port", CollectionTelemetry, MetricsRegistry, VirtualClock,
             SearchStats)):
        clock, reg = clock_cls(), reg_cls()
        tel = tel_cls(clock=clock, metrics=reg, labels=LABELS)
        _record_sequence(tel, clock, stats_cls)
        out[name] = (reg.prometheus_text(), tel.snapshot())
    help_line = re.compile(r"^# HELP ann_recompiles_total .*$", re.M)
    assert "ann_recompiles_total{" not in out["port"][0]
    assert help_line.sub("", out["port"][0]) == \
        help_line.sub("", out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    assert 'tenant="t",collection="c\\"q\\\\"' in out["port"][0]


def test_histogram_and_registry_semantics():
    reg = MetricsRegistry()
    h = reg.histogram("lat", "latency", ("a",), buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 3.0):
        h.observe(v, a="x")
    cum, total, count = h.snapshot(a="x")
    assert list(cum.values()) == [1, 3, 4] and count == 4
    assert total == pytest.approx(4.05)
    assert h.quantile(0.5, a="x") == 1.0
    g = reg.gauge("g", "", ("a",))
    g.set(2, a="x")
    g.inc(3, a="x")
    assert g.value(a="x") == 5
    assert reg.counter("c") is reg.counter("c")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("c")
    text = reg.prometheus_text()
    assert 'lat_bucket{a="x",le="+Inf"} 4' in text
    assert "# TYPE g gauge" in text


# ------------------------------------------------- flush scheduler tree


def test_flush_two_request_interleaving_exact_tree(ds):
    """Scripted interleaving: r0 parks on the (never-reached) deadline,
    r1 arrives 1 virtual ms later and completes the size-2 bucket — one
    flush serves both.  The full span forest is asserted exactly."""
    vc = VirtualClock()
    rec = TraceRecorder(clock=vc)
    col = _collection(ds, "c", vc, rec, max_batch=2,
                      max_wait_ms=10_000.0)
    try:
        user = col.new_user()
        enc = [user.encrypt_query(q) for q in ds.queries[:2]]
        f0 = col.submit(*enc[0], K)
        vc.wait_for_waiters(1)             # worker parked on deadline
        vc.advance(0.001)
        f1 = col.submit(*enc[1], K)        # fills the bucket: size flush
        r0, r1 = f0.result(timeout=30), f1.result(timeout=30)
        assert r0.shape == (K,) and r1.shape == (K,)
    finally:
        col.close()

    assert sorted(rec.trace_ids()) == ["t/c:b0", "t/c:i0", "t/c:r0",
                                       "t/c:r1"]
    (ins,) = rec.tree("t/c:i0")
    assert _shape(ins) == ("insert", [])
    assert ins["attrs"]["n_rows"] == 64
    assert ins["attrs"]["compacted"] is False

    (flush,) = rec.tree("t/c:b0")
    assert _shape(flush) == ("flush", [FIRST_ENGINE_TREE])
    assert flush["attrs"]["n_real"] == 2
    assert flush["attrs"]["bucket"] == 2
    assert flush["attrs"]["backend"] == "flat"
    assert flush["attrs"]["n_queries"] == 2
    assert flush["attrs"]["filter_dist_evals"] > 0
    assert flush["attrs"]["filter_bytes_scanned"] > 0
    (eng,) = flush["children"]
    assert _intervals(eng) == {(0.001, 0.001)}
    _, filt, ref = eng["children"]
    assert "device_s" not in filt["attrs"] and "device_s" not in ref["attrs"]
    assert filt["attrs"]["nq"] == 2
    assert filt["attrs"]["dist_evals"] == \
        flush["attrs"]["filter_dist_evals"]
    assert ref["attrs"]["comparisons"] == \
        flush["attrs"]["refine_comparisons"]

    (req0,) = rec.tree("t/c:r0")
    assert _shape(req0) == ("request",
                            [("queue", []), ("flush", []), ("emit", [])])
    assert req0["attrs"]["scheduler"] == "microbatcher"
    assert req0["attrs"]["k"] == K
    assert req0["attrs"]["backend"] == "flat"
    q0, fl0, em0 = req0["children"]
    assert (q0["t_start"], q0["t_end"]) == (0.0, 0.001)
    assert (fl0["t_start"], fl0["t_end"]) == (0.001, 0.001)
    assert (em0["t_start"], em0["t_end"]) == (0.001, 0.001)
    assert fl0["attrs"]["batch"] == "t/c:b0"
    assert (req0["t_start"], req0["t_end"]) == (0.0, 0.001)

    (req1,) = rec.tree("t/c:r1")
    q1 = req1["children"][0]
    assert (q1["t_start"], q1["t_end"]) == (0.001, 0.001)
    assert req1["children"][1]["attrs"]["batch"] == "t/c:b0"


def test_continuous_scheduler_exact_tree(ds):
    vc = VirtualClock()
    rec = TraceRecorder(clock=vc)
    col = _collection(ds, "s", vc, rec, scheduler="continuous",
                      max_batch=2)
    try:
        user = col.new_user()
        enc = [user.encrypt_query(q) for q in ds.queries[:2]]
        assert col.submit(*enc[0], K).result(timeout=30).shape == (K,)
        assert col.submit(*enc[1], K).result(timeout=30).shape == (K,)
    finally:
        col.close()

    for i in range(2):
        (req,) = rec.tree(f"t/s:r{i}")
        assert _shape(req) == ("request", [("queue", []), ("slot", []),
                                           ("emit", [])])
        assert req["attrs"]["scheduler"] == "slotloop"
        slot = req["children"][1]
        assert slot["attrs"]["batch"] == f"t/s:s{i}"
        (step,) = rec.tree(f"t/s:s{i}")
        assert _shape(step) == ("step", [FIRST_ENGINE_TREE if i == 0
                                         else ENGINE_TREE])
        assert _intervals(step) == {(step["t_start"], step["t_end"])}
        assert step["attrs"]["n_active"] == 1
        assert step["attrs"]["capacity"] == 2


def test_slot_loop_shared_step_interleaving():
    """A stalls in step s0; B and C are admitted while s0 is in flight
    and ride step s1 together — the slot spans name the shared step."""
    entered, gate = threading.Event(), threading.Event()

    def eng(Q, T, k, ratio_k=8.0, ef_search=96):
        entered.set()
        gate.wait(timeout=10.0)
        Q = np.atleast_2d(Q)
        ids = np.round(Q[:, 0]).astype(np.int64)[:, None] + np.arange(k)
        return ids, SearchStats(latency_s=0.0, filter_dist_evals=0,
                                refine_comparisons=0, bytes_up=0,
                                bytes_down=0, n_queries=Q.shape[0],
                                backend="fake")

    def req(i):
        return np.full(D, float(i), np.float32), np.zeros(2 * D + 16,
                                                          np.float32)

    vc = VirtualClock()
    rec = TraceRecorder(clock=vc)
    with SlotLoop(eng, max_batch=4, d=D, cdim=2 * D + 16, clock=vc,
                  name="nm", tracer=rec) as sl:
        fa = sl.submit(*req(1), K)
        assert entered.wait(timeout=10.0)
        entered.clear()
        fb = sl.submit(*req(2), K)
        fc = sl.submit(*req(3), K)
        gate.set()
        for i, f in zip((1, 2, 3), (fa, fb, fc)):
            np.testing.assert_array_equal(f.result(timeout=10),
                                          i + np.arange(K))

    def batch_of(tid):
        (tree,) = rec.tree(tid)
        return tree["children"][1]["attrs"]["batch"]

    assert batch_of("nm:r0") == "nm:s0"
    assert batch_of("nm:r1") == "nm:s1"
    assert batch_of("nm:r2") == "nm:s1"
    (s1,) = rec.tree("nm:s1")
    assert s1["attrs"]["n_active"] == 2


# ------------------------------------------ facade, exports, endpoint


def test_observability_facade_and_exports(ds, tmp_path):
    """One recorder + registry + profiler on the collection's clock: the
    metrics text parses line by line, histogram buckets are cumulative,
    and the Chrome trace loads as JSON."""
    vc = VirtualClock()
    obs = Observability(clock=vc)
    col = _collection(ds, "svc", vc, obs.recorder, max_batch=1,
                      metrics=obs.metrics)
    try:
        user = col.new_user()
        for q in ds.queries:
            assert col.search(*user.encrypt_query(q), K).shape == (K,)
    finally:
        col.close()
    text = obs.metrics_text()
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
                        r'(\{[^{}]*\})? (\+Inf|[-+0-9.eE]+)$')
    for line in text.strip().splitlines():
        assert line.startswith("#") or sample.match(line), line
    assert 'ann_requests_total{tenant="t",collection="svc"} 4' in text
    buckets = re.findall(
        r'ann_request_latency_seconds_bucket\{[^}]*le="([^"]+)"\} (\d+)',
        text)
    counts = [int(c) for _, c in buckets]
    assert counts == sorted(counts) and buckets[-1] == ("+Inf", "4")
    out = tmp_path / "trace.json"
    assert obs.export_chrome_trace(out) == str(out)
    data = json.loads(out.read_text())
    assert data["traceEvents"]
    for ev in data["traceEvents"]:
        assert ev["ph"] in ("X", "M", "i")
    assert any(e["kind"] == "span" for e in obs.events())


def test_start_metrics_server_scrape():
    class Source:
        def metrics_text(self):
            return "demo_metric 1\n"

    server = start_metrics_server(Source(), 0, host="127.0.0.1")
    try:
        port = server.server_address[1]
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read()
        assert body == b"demo_metric 1\n"
    finally:
        server.shutdown()


# ------------------------------------------------------ kernel profiler


def test_profiler_records_host_calls_not_compiling_calls(monkeypatch):
    """instrument() wrappers record host-clock time + bytes for calls on
    CPU tensors, and pass straight through while torch.compile traces."""
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2.0

    wrapped = obs_profiler.instrument("test.fn", fn)
    x = torch.ones((8, 4))
    assert obs_profiler.active_profiler() is None
    wrapped(x)                             # inactive: not recorded
    with profile_kernels() as prof:
        wrapped(x)                         # host call: recorded
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        wrapped(x)                         # under tracing: skipped
        monkeypatch.undo()
        assert obs_profiler.active_profiler() is prof
    assert obs_profiler.active_profiler() is None
    summary = prof.summary()
    assert summary["test.fn"]["calls"] == 1
    assert summary["test.fn"]["total_bytes"] == x.nbytes
    assert summary["test.fn"]["total_s"] > 0
    assert len(calls) == 3                 # fn itself ran every time
    assert wrapped.__wrapped__ is fn


def test_profiler_counts_calls_by_kernel(ds):
    """Searches under profile_kernels() attribute one filter call and one
    refine call a batch to their kernel entry points, by name."""
    col = Collection("t", "prof", D, sap_beta=1.0, seed=1, max_batch=2,
                     max_wait_ms=1.0, device="cpu")
    try:
        col.insert(ds.base[:64])
        col.compact()                          # all rows in the main region
        user = col.new_user()
        Q, T = map(np.stack, zip(*(user.encrypt_query(q)
                                   for q in ds.queries)))
        with profile_kernels() as prof:
            for _ in range(3):
                col.search_batch(Q, T, K)
        summary = prof.summary()
        assert summary["l2_topk.knn"]["calls"] == 3
        assert summary["dce_comp.refine_topk"]["calls"] == 3
        assert prof.total_seconds("l2_topk") > 0
        assert prof.total_bytes("l2_topk") > 0
        col.insert(ds.base[64:80])             # a delta: two scans a batch
        with profile_kernels() as prof:
            col.search_batch(Q, T, K)
        assert prof.summary()["l2_topk.knn"]["calls"] == 2
    finally:
        col.close()
    assert l2_ops.knn.__wrapped__ is not None
    assert dce_ops.batched_top_k_by_wins.__wrapped__ is not None


def test_profiler_counters_table():
    """count() adds to a kernel's counters while the profiler is active;
    summary().counters holds them beside the kernel and span tables (a
    Summary made without them has an empty table), reset() clears them,
    and the plain versions on CPU tensors plan no blocks, so add none."""
    prof = obs_profiler.KernelProfiler()
    prof.count("k", work_tiles=3, slot_tiles=4)
    prof.count("k", work_tiles=5, slot_tiles=6)
    prof.count("j", work_tiles=1)
    s = prof.summary()
    assert s.counters == {"k": {"work_tiles": 8, "slot_tiles": 10},
                          "j": {"work_tiles": 1}}
    assert dict(s) == {} and s.spans == {}
    prof.reset()
    assert prof.summary().counters == {}
    assert obs_profiler.Summary({}, {}).counters == {}
    Q, X = torch.randn(4, 8), torch.randn(600, 8)
    with profile_kernels() as prof:
        l2_ops.knn(Q, X, 5)
    assert prof.summary().counters == {}
    assert prof.summary()["l2_topk.knn"]["calls"] == 1


# ------------------------------------------- the engine's spans as sinks


@pytest.fixture(scope="module")
def engine_inputs(ds):
    owner = ppanns.DataOwner(d=D, sap_beta=dcpe.suggest_beta(
        ds.base, fraction=0.05), seed=3)
    db = owner.encrypt_database(ds.base, build_index=False)
    user = ppanns.User(owner.share_keys())
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    return db.C_sap, db.C_dce, Q, T


SPAN_NAMES = ("engine.search_batch", "filter", "filter.query_prep",
              "refine", "engine.wait")


@pytest.mark.parametrize("quant", [None, "int8"])
def test_profile_kernels_counts_the_engine_spans(engine_inputs, quant):
    """Under profile_kernels() each batch adds one engine.search_batch,
    filter, filter.query_prep and refine call and three engine.wait
    calls (the trapdoors going up, the ids coming down, the comparison
    count) to the span table, with host seconds; the whole call outlasts
    its waits.  The kernel table holds the kernels alone (int8: its query
    encode under an entry of its own beside the scan's), and no sync is
    counted without a card."""
    C_sap, C_dce, Q, T = engine_inputs
    eng = SecureSearchEngine(C_sap, C_dce, quantization=quant, device="cpu")
    eng.search_batch(Q, T, K)                     # attach outside
    with profile_kernels() as prof:
        for _ in range(3):
            eng.search_batch(Q, T, K)
    s = prof.summary()
    sp = s.spans
    assert {n: sp[n]["calls"] for n in SPAN_NAMES} == {
        "engine.search_batch": 3, "filter": 3, "filter.query_prep": 3,
        "refine": 3, "engine.wait": 9}
    assert all(sp[n]["total_s"] > 0 and "syncs" not in sp[n]
               for n in SPAN_NAMES)
    whole = sp["engine.search_batch"]["total_s"]
    assert whole >= sp["engine.wait"]["total_s"]
    assert whole >= sp["filter"]["total_s"] + sp["refine"]["total_s"]
    entries = ({"adc_topk.sq_encode_queries", "adc_topk.sq_knn"} if quant
               else {"l2_topk.knn"}) | {"dce_comp.refine_topk"}
    assert set(s) == entries
    assert all(s[e]["calls"] == 3 for e in entries)
    assert prof.total_seconds() == pytest.approx(
        sum(s[e]["total_s"] for e in entries))


def test_profile_kernels_counts_syncs_inside_spans(monkeypatch):
    """On a machine with a card, profile_kernels() turns PyTorch's sync
    check to "warn" and counts its warnings in the spans open when they
    come (here raised by hand, with no card), swallowing them and the
    check's own notice; other warnings pass, and the check's mode is
    restored after."""
    modes, shown = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)

    def set_mode(mode):                 # warns as PyTorch's does
        modes.append(mode)
        warnings.warn("Synchronization debug mode is a prototype feature")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    sync = "called a synchronizing CUDA operation (Triggered internally)"
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda msg, *a, **kw: shown.append(str(msg))
        with profile_kernels() as prof:
            with child_span("outer"):
                warnings.warn(sync)
                with child_span("inner"):
                    warnings.warn(sync)
                    warnings.warn(sync)
                warnings.warn("other")
            with child_span("outer"):
                pass
        warnings.warn("after")
    assert modes == ["warn", 0] and shown == ["other", "after"]
    assert prof.syncs == 3
    sp = prof.summary().spans
    assert sp["outer"]["calls"] == 2 and sp["outer"]["syncs"] == 3
    assert sp["inner"] == {"calls": 1, "total_s": sp["inner"]["total_s"],
                           "syncs": 2}
    prof.reset()
    assert prof.summary().spans == {} and prof.syncs == 0


def test_torch_profiler_sees_the_spans_as_nested_ranges(engine_inputs):
    """While torch.profiler records, each span is a host range of its own
    name, nested as the span tree is."""
    C_sap, C_dce, Q, T = engine_inputs
    eng = SecureSearchEngine(C_sap, C_dce, device="cpu")
    eng.search_batch(Q, T, K)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.search_batch(Q, T, K)
    ranges = {}
    for e in prof.events():
        if e.name in SPAN_NAMES:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    assert {n: len(r) for n, r in ranges.items()} == {
        "engine.search_batch": 1, "filter": 1, "filter.query_prep": 1,
        "refine": 1, "engine.wait": 3}

    def inside(child, parent):
        (p0, p1), = ranges[parent]
        return all(p0 <= c0 <= c1 <= p1 for c0, c1 in ranges[child])

    assert inside("filter", "engine.search_batch")
    assert inside("refine", "engine.search_batch")
    assert inside("filter.query_prep", "filter")
    assert inside("engine.wait", "refine")
    (f0, f1), = ranges["filter"]
    (r0, r1), = ranges["refine"]
    assert f1 <= r0


class _FakeEvents:
    """Stand-ins for a card call's two CUDA events: `elapsed_time` in ms,
    and a count of the waits the profiler makes on them."""

    def __init__(self, ms):
        self.ms, self.waits = ms, 0
        self.start = self

    def synchronize(self):
        self.waits += 1

    def elapsed_time(self, end):
        return self.ms


def test_deferred_card_calls_read_at_summary_dropped_at_reset():
    """A card call's events are queued, not waited on: summary() reads
    them (calls, seconds, bytes as a timed call gave them) and reset()
    forgets them unread."""
    prof = obs_profiler.KernelProfiler()
    a, b = _FakeEvents(2.0), _FakeEvents(3.0)
    prof.defer("k", a.start, a, 100)
    prof.defer("k", b.start, b, 50)
    prof.record("host", 0.5, 8)
    assert a.waits == b.waits == 0
    s = prof.summary()
    assert s["k"] == {"calls": 2, "total_s": pytest.approx(0.005),
                      "total_bytes": 150}
    assert s["host"] == {"calls": 1, "total_s": 0.5, "total_bytes": 8}
    assert a.waits == b.waits == 1
    assert prof.summary() == s                      # read once
    c = _FakeEvents(1.0)
    prof.defer("k", c.start, c, 1)
    prof.reset()
    assert prof.summary() == {} and c.waits == 0
    assert prof.summary().spans == {}


# ------------------------------------------------------- disabled mode


def test_disabled_mode_is_noop(ds, monkeypatch):
    """No sink active: child_span hands out the one shared no-op span,
    no ambient context exists, and nothing records: no profiler range
    opens, no kernel profiler entry and no CUDA event is made."""
    made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **kw: made.append("range"))
    monkeypatch.setattr(obs_profiler.KernelProfiler, "record",
                        lambda *a, **kw: made.append("record"))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **kw: made.append("event"))
    assert current() is None and obs_profiler.active_profiler() is None
    assert not torch.autograd._profiler_enabled()
    sp = child_span("anything", x=1)
    assert sp is child_span("other")
    with sp as s:
        s.set(y=2)
        s.device_open(torch.device("cuda"))
        s.device_close()
        s.device_resolve()
    with NULL_RECORDER.span("op", "tid") as s:
        s.set(z=3)
    assert NULL_RECORDER.spans() == []
    assert NULL_RECORDER.tree("tid") == []

    col = Collection("t", "off", D, sap_beta=1.0, seed=1, max_batch=2,
                     max_wait_ms=1.0, device="cpu")
    try:
        col.insert(ds.base[:32])
        user = col.new_user()
        ids = col.search(*user.encrypt_query(ds.queries[0]), K)
        assert ids.shape == (K,)
        assert current() is None
    finally:
        col.close()
    assert made == []
