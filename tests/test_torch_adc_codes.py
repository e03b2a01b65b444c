"""`core.adc_codes`, the one owner of the int8 / pq8 code format on the
device, on the CPU: the layout it holds, appended rows against a whole
encode (as tensors and as row-sharded blocks), the query operand against
the codebook's, and its scans against the `adc_topk.ops` functions on the
same tensors.  The filters that hold it are held to the JAX package by
tests/test_torch_adc.py, test_torch_graph.py, test_torch_mutation.py and
test_torch_placement.py."""

import numpy as np
import pytest
import torch

from repro_torch.core import adc, adc_codes
from repro_torch.kernels import _build
from repro_torch.kernels.adc_topk import ops as adc_ops
from repro_torch.obs.profiler import profile_kernels
from repro_torch.obs.trace import TraceRecorder
from repro_torch.serving.search_engine import layout_pools, pool_membership
from repro_torch.serving.sharded import RowSharded

N, D, BUCKET, PQ_M = 300, 16, 512, 4
QUANTS = ["int8", "pq8"]


@pytest.fixture(autouse=True)
def no_kernel_launch(monkeypatch):
    """On the CPU no wrapper may reach the CUDA build or launch path."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached the kernel launch path")
    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    C = rng.standard_normal((N, D)).astype(np.float32)
    Q = rng.standard_normal((6, D)).astype(np.float32)
    return C, Q


def _put(buf, axis):
    return torch.from_numpy(buf)


def _write(dst, lo, hi, rows, axis):
    src = torch.from_numpy(np.ascontiguousarray(rows))
    (dst[lo:hi] if axis == 0 else dst[:, lo:hi]).copy_(src)


def _codes(quant, C, bucket=BUCKET):
    codes = adc_codes.make(quant)
    codes.train(C, m=PQ_M, seed=3)
    codes.encode(C, bucket, _put)
    return codes


def test_make_and_the_oversampling_rule():
    assert adc_codes.make(None) is None
    assert isinstance(adc_codes.make("int8"), adc_codes.SQCodes)
    assert isinstance(adc_codes.make("pq8"), adc_codes.PQCodes)
    assert adc_codes.refine_ratio("int8") == 2.0
    assert adc_codes.refine_ratio("pq8") == 4.0
    assert adc_codes.refine_ratio(None) == 1.0
    assert adc_codes.refine_ratio("pq8", 3) == 3.0
    assert adc_codes.oversampled(80, 2.0) == 160
    assert adc_codes.oversampled(7, 1.5) == 11      # ceil
    assert adc_codes.oversampled(80, 0.5) == 80     # never below k'


@pytest.mark.parametrize("quant", QUANTS)
def test_layout_dtypes_shapes_and_zero_padding(rows, quant):
    C, _ = rows
    codes = _codes(quant, C)
    cb = codes.codebook
    assert codes.kind == quant and cb.kind == quant
    assert codes.row_bytes == cb.code_bytes_per_vector()
    if quant == "int8":
        c8, cn = codes.arrays
        want_c8, want_cn = cb.encode(C)
        assert codes.axes == (0, 0)
        assert c8.dtype == torch.int8 and c8.shape == (BUCKET, D)
        assert cn.dtype == torch.int32 and cn.shape == (BUCKET,)
        np.testing.assert_array_equal(c8[:N].numpy(), want_c8)
        np.testing.assert_array_equal(cn[:N].numpy(), want_cn)
        assert not c8[N:].any() and not cn[N:].any()
    else:
        (ct,) = codes.arrays
        assert codes.axes == (1,)
        assert ct.dtype == torch.uint8 and ct.shape == (PQ_M, BUCKET)
        np.testing.assert_array_equal(ct[:, :N].numpy(), cb.encode(C).T)
        assert not ct[:, N:].any()
    # a bucket of exactly n rows is the codes themselves
    whole = _codes(quant, C, bucket=N)
    for a, ax in zip(whole.arrays, whole.axes):
        assert a.shape[ax] == N and a.is_contiguous()


@pytest.mark.parametrize("placement", ["tensor", "sharded"])
@pytest.mark.parametrize("quant", QUANTS)
def test_appended_rows_equal_a_whole_encode(rows, quant, placement):
    """Rows encoded into a bucket already held equal the same bucket
    encoded whole, on one tensor and on row-sharded blocks (each shard's
    view too)."""
    C, _ = rows
    if placement == "tensor":
        put, write = _put, _write
    else:
        devs = [torch.device("cpu")] * 4
        put = lambda buf, axis: RowSharded.put(devs, buf, axis)   # noqa
        write = lambda dst, lo, hi, r, axis: dst.write(lo, hi, r)   # noqa
    held = adc_codes.make(quant)
    held.train(C, m=PQ_M, seed=3)
    held.encode(C[:200], BUCKET, put)
    kept = [a.parts[0] if placement == "sharded" else a for a in held.arrays]
    held.append(C[200:250], 200, write)
    held.append(C[250:], 250, write)
    whole = adc_codes.make(quant)
    whole.codebook = held.codebook
    whole.encode(C, BUCKET, put)
    for a, k in zip(held.arrays, kept):              # written in place
        t = a.parts[0] if placement == "sharded" else a
        assert t.data_ptr() == k.data_ptr()
    if placement == "tensor":
        for a, w in zip(held.arrays, whole.arrays):
            assert torch.equal(a, w)
    else:
        for s in range(4):
            for a, w in zip(held.shard(s), whole.shard(s)):
                assert torch.equal(a, w)


@pytest.mark.parametrize("quant", QUANTS)
def test_query_operand_is_the_codebooks(rows, quant):
    C, Q = rows
    codes = _codes(quant, C)
    rec = TraceRecorder()
    with rec.span("filter", trace_id="q"):
        qop = codes.query_operand(Q, torch.device("cpu"))
    (root,) = rec.tree("q")
    assert [c["name"] for c in root["children"]] == ["filter.query_prep"]
    if quant == "int8":
        want = codes.codebook.encode_query(Q)
        assert qop.dtype == torch.int8
    else:
        want = np.asarray(codes.codebook.lut(Q), np.float32)
        assert qop.dtype == torch.float32 and qop.shape == (6, PQ_M, 256)
    np.testing.assert_array_equal(qop.numpy(), want)


@pytest.mark.parametrize("replace", ["train", "assign"])
def test_int8_offset_follows_a_new_codebook(rows, replace):
    """The offset held a device is made once and dropped when the codebook
    is replaced, by training or by installing one (a snapshot's restore):
    the operand is the new codebook's codes."""
    C, Q = rows
    codes = _codes("int8", C)
    cpu = torch.device("cpu")
    codes.query_operand(Q, cpu)
    held = codes._offset(cpu)
    assert codes._offset(cpu) is held                 # uploaded once
    if replace == "train":
        codes.train(2.0 * C + 1.0, m=PQ_M, seed=3)
    else:
        codes.codebook = adc.SQCodebook.train(2.0 * C + 1.0)
    assert not codes._offsets
    qop = codes.query_operand(Q, cpu)
    assert codes._offset(cpu) is not held
    np.testing.assert_array_equal(qop.numpy(),
                                  codes.codebook.encode_query(Q))
    assert not np.array_equal(qop.numpy(),
                              adc.SQCodebook.train(C).encode_query(Q))


@pytest.mark.parametrize("quant", QUANTS)
def test_query_operand_counts_the_rows_it_quantizes(rows, quant):
    """Under the kernel profiler the int8 operand counts its rows where
    they were quantized (here `host_rows`; `card_rows` on the card, in
    test_torch_isolation.py), once a call; pq8 and an inactive profiler
    count nothing."""
    C, Q = rows
    codes = _codes(quant, C)
    cpu = torch.device("cpu")
    codes.query_operand(Q, cpu)
    with profile_kernels() as prof:
        codes.query_operand(Q, cpu)
        codes.query_operand(Q[:1], cpu)
    want = ({"adc_topk.sq_encode_queries": {"host_rows": 7}}
            if quant == "int8" else {})
    assert prof.summary().counters == want
    if quant == "int8":
        assert prof.summary()["adc_topk.sq_encode_queries"]["calls"] == 2
        meta = codes.query_operand(Q, torch.device("meta"))
        assert meta.dtype == torch.int8 and meta.shape == Q.shape


@pytest.mark.parametrize("quant", QUANTS)
def test_scans_equal_the_ops_on_the_same_tensors(rows, quant):
    """knn, pool and oblivious scans (and their distances) are the
    `adc_topk.ops` functions over the held arrays, or over the arrays
    passed as `db=` (a shard's block: here the first 256 rows)."""
    C, Q = rows
    codes = _codes(quant, C)
    qop = codes.query_operand(Q, torch.device("cpu"))
    ok = torch.zeros(BUCKET, dtype=torch.bool)
    ok[:N] = True
    ok[::7] = False
    rng = np.random.default_rng(1)
    pools = [rng.choice(256, size=40 + 5 * i, replace=False)
             for i in range(6)]
    cand, valid = (torch.from_numpy(a) for a in layout_pools(6, pools, 30))
    member = torch.from_numpy(pool_membership(6, pools, BUCKET))
    block = tuple(a[:256] if ax == 0 else a[:, :256]
                  for a, ax in zip(codes.arrays, codes.axes))
    p = "sq" if quant == "int8" else "pq"
    for db, kw, r in ((codes.arrays, {}, BUCKET), (block, {"db": block}, 256)):
        rest = {"pool_dists": (cand, valid), "pool_scan": (cand, valid, 30),
                "oblivious_dists": (member[:, :r],),
                "oblivious_scan": (member[:, :r], 30)}
        want = {"knn": getattr(adc_ops, f"{p}_knn")(qop, *db, 25, ok=ok[:r])}
        got = {"knn": codes.knn(qop, 25, ok[:r], **kw)}
        for name, args in rest.items():
            want[name] = getattr(adc_ops, f"{p}_{name}")(*db, qop, *args)
            got[name] = getattr(codes, name)(qop, *args, **kw)
        for name, w in want.items():
            g, w = (got[name], w) if isinstance(w, tuple) else (
                (got[name],), (w,))
            assert len(g) == len(w), name
            for a, b in zip(g, w):
                assert torch.equal(a, b), name
        _, ids = got["knn"]
        assert (ids >= 0).all() and ok[ids].all()   # masked rows never
