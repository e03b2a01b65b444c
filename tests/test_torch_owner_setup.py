"""The owner's bulk encryption (`core.ppanns.DataOwner.encrypt_vectors`)
and the set-up spans, on the host: the ciphertexts of a call over several
chunks equal the chunks' own calls bit for bit (the chunk seeds, buckets
and padding the benchmark's reference restates), the call holds the DCE
ciphertexts once, and set-up opens `owner.encrypt_vectors` >
`owner.encrypt`, `owner.to_host` for each chunk, and `engine.attach` >
`engine.upload`, `filter.attach` on the engine's first batch."""

import os
import subprocess
import sys
import tracemalloc
from pathlib import Path

import numpy as np

from repro_torch.core import dce, dcpe
from repro_torch.core.ppanns import DataOwner
from repro_torch.obs.trace import TraceRecorder
from repro_torch.serving.search_engine import SecureSearchEngine

CHUNK = DataOwner.CHUNK
SEED = 77
STRIDE = 7919               # seed step from one chunk to the next


def _owner(m: int, d: int):
    P = np.random.default_rng(3).standard_normal((m, d)).astype(np.float32)
    return P, DataOwner(d, sap_beta=dcpe.suggest_beta(P, fraction=0.03),
                        seed=5)


def test_bulk_encryption_equals_its_chunks_bit_for_bit():
    P, owner = _owner(2 * CHUNK + 5, 960)
    C_sap, C_dce = owner.encrypt_vectors(P, seed=SEED, device="cpu")
    assert C_sap.shape == (P.shape[0], 960)
    assert C_dce.shape == (P.shape[0], 4, 2 * 960 + 16)
    parts = [owner.encrypt_vectors(P[a:a + CHUNK], seed=SEED + STRIDE * i,
                                   device="cpu")
             for i, a in enumerate(range(0, P.shape[0], CHUNK))]
    assert [a.shape[0] for a, _ in parts] == [CHUNK, CHUNK, 5]
    for got, want in ((C_sap, [a for a, _ in parts]),
                      (C_dce, [b for _, b in parts])):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.concatenate(want).view(np.uint32))


def test_bulk_encryption_holds_its_outputs_once():
    """The host peak of one call (numpy's allocations, under tracemalloc)
    stays under 1.3x the two outputs: no concatenated copy of C_dce."""
    P, owner = _owner(2 * CHUNK + 5, 960)
    owner.encrypt_vectors(P[:8], seed=1, device="cpu")     # warm
    tracemalloc.start()
    try:
        C_sap, C_dce = owner.encrypt_vectors(P, seed=SEED, device="cpu")
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    out = C_sap.nbytes + C_dce.nbytes
    assert out <= peak < 1.3 * out, (peak, out)


RSS_SCRIPT = """
import resource, sys
import numpy as np
from repro_torch.core import dcpe
from repro_torch.core.ppanns import DataOwner
m, d = 16 * DataOwner.CHUNK + 5, 128
P = np.random.default_rng(3).standard_normal((m, d)).astype(np.float32)
owner = DataOwner(d, sap_beta=dcpe.suggest_beta(P, fraction=0.03), seed=5)
owner.encrypt_vectors(P[:8], seed=1, device="cpu")
r0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
C_sap, C_dce = owner.encrypt_vectors(P, seed=77, device="cpu")
r1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print((r1 - r0) * 1024 / (C_sap.nbytes + C_dce.nbytes))
"""


def test_bulk_encryption_peak_resident_memory():
    """What tracemalloc cannot see (the chunks' tensors live in torch's
    allocator): over 16 chunks the process's peak resident memory grows
    by under 1.6x the outputs (1.19-1.32x measured: C_dce once, C_sap's
    chunks beside their concatenation; C_dce's chunks beside theirs too
    grow it by 2.1-2.2x).  One thread and one malloc arena keep the
    reading steady."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + ([os.environ["PYTHONPATH"]]
                 if os.environ.get("PYTHONPATH") else [])),
        OMP_NUM_THREADS="1", MALLOC_ARENA_MAX="1")
    res = subprocess.run([sys.executable, "-c", RSS_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    growth = float(res.stdout.split()[-1])
    assert growth < 1.6, growth


def test_setup_spans_nest_under_a_recorder():
    m, d = CHUNK + 5, 16
    P, owner = _owner(m, d)
    keys = owner.share_keys()
    Q_sap = dcpe.encrypt(P[:4], keys.sap_key, seed=1)
    T = dce.trapgen(P[:4], keys.dce_key, seed=2)
    rec = TraceRecorder()
    with rec.span("setup", trace_id="s"):
        C_sap, C_dce = owner.encrypt_vectors(P, seed=SEED, device="cpu")
        engine = SecureSearchEngine(C_sap, C_dce, device="cpu")
        engine.search_batch(Q_sap, T, 5)
        engine.search_batch(Q_sap, T, 5)           # attached: no span
    (root,) = rec.tree("s")
    enc, first, second = root["children"]
    assert enc["name"] == "owner.encrypt_vectors"
    assert enc["attrs"] == {"rows": m, "bytes": C_sap.nbytes + C_dce.nbytes}
    assert [c["name"] for c in enc["children"]] == \
        ["owner.encrypt", "owner.to_host"] * 2
    row_bytes = 4 * (d + 4 * (2 * d + 16))
    for c, rows in zip(enc["children"], (CHUNK, CHUNK, 5, 5)):
        assert c["attrs"] == {"rows": rows, "bytes": rows * row_bytes}
        assert c["children"] == []

    assert [c["name"] for c in first["children"]] == \
        ["engine.attach", "filter", "refine"]
    (attach, *_) = first["children"]
    upload, fattach = attach["children"]
    assert (upload["name"], fattach["name"]) == ("engine.upload",
                                                 "filter.attach")
    assert upload["attrs"] == {"bytes": C_dce.nbytes}
    assert fattach["attrs"] == {"backend": "flat", "bytes": C_sap.nbytes}
    assert "engine.attach" not in [c["name"] for c in second["children"]]
