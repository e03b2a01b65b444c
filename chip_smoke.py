#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py            # flat and ADC paths at SIFT1M scale
                                     # (n = 1M), graph path at n = 100,000
    python3 chip_smoke.py --graph-n 20000 --n 20000 --queries 64  # quick

Phases, each of which fails the run (non-zero exit, no final line):

1. Device and build: the card's name and power limit, the torch and
   CUDA versions, and the build of the CUDA kernels from
   `src/repro_torch/csrc/` (with nvcc's register and spill report).
   Then the graph path's corpus is made and encrypted on the card, and
   the owner's HNSW build over it (host numpy, minutes at 100k rows)
   starts in a worker process, so it runs while phases 2 to 4 use the
   card; 1,000 more rows of the same mixture are encrypted with the same
   keys for phase 6's graph inserts.
2. Kernels against their plain PyTorch versions on the card, at the
   shapes the main paths give them, with times (CUDA events), bounds
   and a library yardstick where one PyTorch call computes the same
   function.  Tolerances:
     l2_topk.knn (the flat filter's fused scan + top-k'; 1% of rows
     duplicated, so exact ties occur): ids equal to the plain chunked
     merge in >= 99.9% of slots, distances within 1e-5 * (||q||^2 +
     ||x||^2) where the ids agree (fp32 sums in another order);
     dce_comp.refine_topk (the fused refine, on real DCE ciphertexts
     read through a shuffled cand, ~10% of slots invalid): win counts
     equal to those of the Z entry exactly (one main loop), and wins and
     ids equal to the plain version wherever every pair has |Z_plain| >
     1e-5 * max|Z| (the rest is reported);
     sq_adc_topk / pq_adc_topk (quantized scan + top-kp): ids and
     distances exactly equal (int32 surrogates; float32 sums taken in
     the same subspace order), exhausted slots included; an `adc_split`
     line before each of their records splits the call's device time
     into scan, selection and merge (torch.profiler by kernel; the scan
     alone is the same call with every row masked);
     l2 tiles: |kernel - plain| <= 1e-5 * (||q||^2 + ||x||^2);
     Z tiles:  |kernel - plain| <= 1e-5 * max|Z|, and equal signs
               wherever |Z_plain| > 1e-5 * max|Z|;
     both because the hand kernel and cuBLAS sum in different orders in
     true fp32.
     graph_expand.graph_walk (the fused walk: upper-layer descent and
     layer-0 beam search, one launch) on synthetic graphs with upper
     layers (3 of them empty padded layers) at R 2^17 / M0 16, R 2^20 /
     M0 32, d 960, R 2^21 (the visited bitmap in device memory) and
     ef_cap 2048, and graph_expand.expand_layer0 (its layer-0 entry) at
     its three shapes, over a random adjacency (some -1 slots, some rows
     with ok = 0) and integer-valued rows, so every distance is exact in
     both summation orders: ids, distances, visited words, hops and
     edges bit-equal to the torch walk's;
     dce_comp.z_matrix (K3, its column tiles split over more blocks):
     within the Z tolerance of the plain version, and bit-equal to the
     batched entry's Z of the same set;
     the fused top-k scans also at k' 1600 (two passes of 800 each).
3. The flat path: a synthetic SIFT-width corpus (clustered Gaussians)
   encrypted on the card by `DataOwner.encrypt_vectors`, queries
   encrypted by `User`, and `SecureSearchEngine(backend="flat")` on the
   card answering them in batches of 32 (k = 10, k' = 80; one fused
   l2_topk.knn and one fused dce_comp.refine_topk call a batch), once
   through the kernels and once with the kernels swapped for their plain
   versions.  Final ids must agree in >= 99.9% of slots and recall@10
   within 0.005 (ulp-level near-ties at the k' boundary may flip).  Then
   4 batches at k = 200 (k' 1600, above the scan's 1024 a pass), kernels
   against plain versions (`k1600_path`).  A
   small database is also searched on the card and on the host (plain
   versions) from the numpy encryption, through the flat, IVF, ADC
   (int8 / pq8, flat / IVF) and ADC graph filters: the ids must agree
   as on the flat path.
4. The ADC paths, after the flat engine is freed, on the same
   ciphertexts and queries: `SecureSearchEngine(backend="flat",
   quantization="int8" | "pq8")` (codebook trained on the host at
   attach; sq_adc_topk or pq_adc_topk once per batch, refine_topk for
   the refine), each once through the kernels and once with them swapped for
   their plain versions on the same engine (same limits as the flat
   path), and each with 1600 candidates (k = 100 int8, k = 50 pq8) as
   the flat path; then `backend="ivf", quantization="int8"` (64
   partitions, nprobe 8), also against its plain versions.
5. The graph path, after the ADC engines are freed:
   `SecureSearchEngine(backend=GraphFilter(index))` over the HNSW of
   phase 1 (M = 8, ef_construction = 48), the same batches, k = 10,
   ratio_k = 8, ef_search = 96: once through the kernels (one
   graph_walk and one refine_topk launch a batch, and no torch
   descent), once with both swapped for their plain versions (same
   limits as the flat path), and the per-query host walk
   (`HNSWGraphFilter`) on the first 64 queries.  `graph_breakdown`
   times the fused walk against the parent's torch descent and the
   layer-0 entry alone, and the scan trace's download.

6. The serving runtime (`serving/runtime`), run after phase 4 and
   before phase 5, on phase 3's ciphertexts and queries and phase 1's
   graph corpus and HNSW (nothing re-encrypted, no HNSW rebuilt), every
   collection keyless on the card and each freed before the next:
   (a) a flat collection under the flush micro-batcher (max_batch 32,
       2 ms): `load_snapshot` of rows 0..n-10,001, `warmup`, then 8 client
       threads submitting 128 queries each; their ids must equal the
       collection's direct `search_batch` in 100% of slots;
   (f) one more flush pass under `profile_kernels()`: calls and
       CUDA-event ms by kernel beside phase 2's device ms (report only);
   (b) live ingestion on (a): the 10,000 held-out rows in 10 bursts of
       1,000, a batch after each (two K1 calls a batch while the delta is
       non-empty), all queries (ids >= 99.9% equal to the same
       collection's with the kernels swapped for their plain versions),
       `compact()` (ids >= 99.9% equal to phase 3's flat ids), 1,000
       deletes (some of them ids of those answers: none may come back;
       plain ids again), and no kernel rebuild after warmup;
   (c) the same rows and operations under the continuous slot loop, each
       search through client threads: ids equal to (a)/(b)'s in 100% of
       slots at every checkpoint;
   (d) an int8 collection over the 1M rows with (b)'s deletes (K4 with
       the `ok` stream), and a pq8 collection over the graph corpus (K5),
       each against its plain run;
   (e) a graph collection over the graph corpus (`graph_arrays` = the
       HNSW's `to_arrays()`): 1% of its rows deleted, then the 1,000
       rows phase 1 held out inserted; ids against the plain torch walk
       after each, and no deleted id returned.
   One `runtime_path` line each; their launches join the `kernels` line
   as `launches_by_path` runtime_flat, runtime_flat_continuous,
   runtime_int8, runtime_pq8 and runtime_graph.
7. The public API (`repro_torch.api`) and the leakage harness
   (`repro_torch.sec.leakage`), run after phase 6 and before phase 5, on
   the ciphertexts the script already holds:
   (a) the three roles over phase 3's corpus: `DataOwnerClient` around
       phase 3's keys (`DataOwner.from_keys`), its keys exported to a
       keystore, `QueryClient.from_keystore(seed=17)` whose query
       ciphertexts must equal phase 3's byte for byte, and a keyless
       flat collection made from phase 3's ciphertexts; batch requests
       of 32 (each request and result through `to_bytes` /
       `from_bytes`) whose ids must equal phase 3's in 100% of slots,
       with one l2_topk.knn and one refine_topk launch each, then 8
       client threads submitting 128 coalesced single-query requests
       each, whose ids must equal the batch ids in 100% of slots;
   (b) persistence over phase 1's graph corpus: a graph collection (the
       owner's HNSW arrays) and a flat int8 collection, each searched,
       saved to a `.ppcol`, closed, loaded into a fresh service and
       searched again (ids equal in 100% of slots, no kernel build or
       load after the load), then one held-out row inserted and found
       and one answered id deleted and never returned;
   (c) the leakage harness at BENCH_attacks.json's replay scale (2,048
       rows, d 32, 64 queries): a graph collection's scan trace with the
       kernels bit-equal to its trace with their plain versions, then
       `evaluate_profile` for every profile x (ivf, ivf+int8, graph)
       and the bars of tests/test_leakage.py.
   One `api_path` line per collection and one `leakage` line; the
   launches join the `kernels` line as `launches_by_path` api_flat,
   api_graph and api_int8.

The second-to-last line is the kernels' JSON record, the last line the
device record.  Without a CUDA device the script exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, dense
# int8 on the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12

K = 10
RATIO_K = 8
BATCH = 32
L2_RTOL = 1e-5
Z_RTOL = 1e-5
MIN_ID_AGREEMENT = 0.999
MAX_RECALL_GAP = 0.005
GRAPH_RTOL = 1e-5
OWNER_SEED = 0
# graph path: the owner's HNSW build settings (those of BENCH_graph.json)
GRAPH_M = 8
GRAPH_EF_CONSTRUCTION = 48
EF_SEARCH = 96
ORACLE_QUERIES = 64
# IVF paths: the reference backend's defaults
IVF_PARTITIONS = 64
IVF_NPROBE = 8


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops = flops / peak
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, in ms.  Before each timed call the
    stream is held busy by a spin kernel, so the host has enqueued the
    start event, the call and the end event before the card reaches
    them: the interval is the call's device time, without the host's
    launch gaps."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)          # ~1 ms of spinning
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 10) -> float:
    """Median host-clock time of a call ended by a synchronize, in ms."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


@contextlib.contextmanager
def plain_kernels():
    """Test-only switch: route the main paths' kernel entry points to
    their plain PyTorch versions, for the comparison runs.  The port
    itself has no such switch."""
    from repro_torch.kernels.adc_topk import adc_topk, ops as adc_ops
    from repro_torch.kernels.dce_comp import dce_comp, ops as dce_ops
    from repro_torch.kernels.graph_expand import graph_expand
    from repro_torch.kernels.graph_expand import ops as graph_ops
    from repro_torch.kernels.l2_topk import l2_topk, ops as l2_ops
    routes = [(l2_ops, "knn", l2_topk.plain_knn),
              (dce_ops, "refine_topk", dce_comp.plain_refine_topk),
              (graph_ops, "graph_walk", graph_expand.plain_graph_walk),
              (adc_ops, "sq_adc_topk", adc_topk.plain_sq_adc_topk),
              (adc_ops, "pq_adc_topk", adc_topk.plain_pq_adc_topk)]
    saved = [getattr(mod, name) for mod, name, _ in routes]
    for mod, name, plain in routes:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), kern in zip(routes, saved):
            setattr(mod, name, kern)


def _launch_counters() -> dict:
    from repro_torch.kernels.adc_topk import adc_topk
    from repro_torch.kernels.dce_comp import dce_comp
    from repro_torch.kernels.graph_expand import graph_expand
    from repro_torch.kernels.l2_topk import l2_topk
    return {"l2_topk": l2_topk.launches, "dce_comp": dce_comp.launches,
            "graph_expand": graph_expand.launches,
            "adc_topk": adc_topk.launches}


def kernel_launches() -> dict:
    """Launch counts by kernel, "module.entry": each wrapper counts the
    launches of its kernel (z_matrix under batched_z_matrix; a pass of a
    top-k above 1024 is a launch)."""
    return {f"{mod}.{k}": v for mod, counts in _launch_counters().items()
            for k, v in counts.items()}


def reset_launches() -> None:
    for counts in _launch_counters().values():
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def untallied():
    """Launches inside the block (timing a kernel alone) leave the
    counts as they were."""
    saved = {mod: dict(c) for mod, c in _launch_counters().items()}
    try:
        yield
    finally:
        for mod, counts in _launch_counters().items():
            counts.update(saved[mod])


# --------------------------------------------------------------- phase 2

def check_l2(nq: int, n: int, d: int, gen) -> dict:
    import torch
    from repro_torch.kernels.l2_topk import l2_topk
    dev = torch.device("cuda")
    # DCPE-like magnitudes: s = 1024 times unit-scale coordinates
    Q = 1024.0 * torch.randn((nq, d), generator=gen, device=dev)
    X = 1024.0 * torch.randn((n, d), generator=gen, device=dev)
    got = l2_topk.pairwise_sq_dists(Q, X)
    want = l2_topk.plain_pairwise_sq_dists(Q, X)
    torch.cuda.synchronize()
    scale = (Q * Q).sum(1)[:, None] + (X * X).sum(1)[None, :]
    err = (got - want).abs()
    rel = float((err / scale).max())
    if not torch.isfinite(got).all() or rel > L2_RTOL:
        raise AssertionError(f"l2 kernel disagrees at nq={nq} n={n} "
                             f"d={d}: max rel err {rel:.3g}")
    base = scale.clone()
    Xt = X.T
    flops = 2.0 * nq * n * d + 2.0 * (nq + n) * d + 3.0 * nq * n
    nbytes = 4.0 * (nq * d + n * d + nq * n)
    b_ms, b_by = bound(flops, nbytes)
    return {
        "name": f"l2_topk.pairwise_sq_dists[nq={nq},n={n},d={d}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/l2_topk.cu",
        "replaces": "src/repro/kernels/l2_topk/l2_topk.py:77",
        "max_abs_err": float(err.max()), "max_rel_err": rel,
        "ms": device_ms(lambda: l2_topk.pairwise_sq_dists(Q, X)),
        "plain_ms": device_ms(lambda: l2_topk.plain_pairwise_sq_dists(Q, X)),
        "library_ms": device_ms(
            lambda: torch.addmm(base, Q, Xt, beta=1.0, alpha=-2.0)),
        "library_call": "torch.addmm(qn+xn, Q, X.T, alpha=-2)",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_knn(nq: int, n: int, d: int, k: int, gen,
              home: str | None = None, exact: bool = False) -> dict:
    """The fused scan against its plain version (the chunked merge over
    plain tiles): DCPE-like magnitudes, the last 1% of rows repeating the
    first, so exact ties between distinct ids occur.  `exact`: integer
    rows and queries in [-8, 8] instead (every distance exact in any
    summation order), and the ids and distances must be equal (the k'
    1600 record: at 1600 slots, fp32 sums in another order swap some
    neighbours within 1e-6 of each other)."""
    import torch
    from repro_torch.kernels.l2_topk import l2_topk
    dev = torch.device("cuda")
    if exact:
        Q = torch.randint(-8, 9, (nq, d), generator=gen, device=dev).float()
        X = torch.randint(-8, 9, (n, d), generator=gen, device=dev).float()
    else:
        Q = 1024.0 * torch.randn((nq, d), generator=gen, device=dev)
        X = 1024.0 * torch.randn((n, d), generator=gen, device=dev)
    dup = n // 100
    if dup:
        X[n - dup:] = X[:dup]
    got = l2_topk.knn(Q, X, k)
    want = l2_topk.plain_knn(Q, X, k)
    torch.cuda.synchronize()
    kk = min(k, n)
    same = got[1] == want[1]
    agree = float(same.float().mean())
    qn = (Q * Q).sum(1)
    xn = (X * X).sum(1)
    scale = qn[:, None] + xn[want[1].clamp(min=0)]
    err = (got[0] - want[0]).abs()[same]
    rel = float((err / scale[same]).max()) if err.numel() else 0.0
    if (got[1].shape != (nq, kk) or not torch.isfinite(got[0]).all()
            or agree < (1.0 if exact else MIN_ID_AGREEMENT)
            or rel > (0.0 if exact else L2_RTOL)):
        raise AssertionError(f"fused l2 scan disagrees at nq={nq} n={n} "
                             f"d={d} k={k}: ids {agree}, max rel err {rel}")
    flops = 2.0 * nq * n * d + 2.0 * (nq + n) * d + 3.0 * nq * n
    nbytes = 4.0 * (nq * d + n * d) + 12.0 * nq * kk
    b_ms, b_by = bound(flops, nbytes)
    base = qn[:, None] + xn[None, :]
    Xt = X.T
    return {
        "name": f"l2_topk.knn[nq={nq},n={n},d={d},k={k}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/l2_topk.cu",
        "replaces": "src/repro/kernels/l2_topk/l2_topk.py:77",
        "max_abs_err": float(err.max()) if err.numel() else 0.0,
        "max_rel_err": rel, "id_agreement": agree,
        "duplicated_rows": dup, "integer_rows": exact,
        "ms": device_ms(lambda: l2_topk.knn(Q, X, k)),
        "plain_ms": device_ms(lambda: l2_topk.plain_knn(Q, X, k),
                              reps=10, warmup=2),
        "library_ms": device_ms(lambda: torch.topk(
            torch.addmm(base, Q, Xt, beta=1.0, alpha=-2.0), kk, dim=1,
            largest=False)),
        "library_call": "torch.addmm(qn+xn, Q, X.T, alpha=-2), "
                        "torch.topk(largest=False)",
        "bound_ms": b_ms, "bound_by": b_by,
        **({"home": home} if home else {}),
    }


def dce_inputs(B: int, n: int, d: int, gen):
    """Real DCE ciphertexts of B candidate sets and trapdoors of B
    queries, each set drawn around its query so near-ties occur."""
    import torch
    from repro_torch.core import dce
    rng = np.random.default_rng(d)
    key = dce.keygen(d, seed=d)
    Qp = rng.standard_normal((B, d)).astype(np.float32)
    P = Qp[:, None, :] + 0.5 * rng.standard_normal((B, n, d)).astype(
        np.float32)
    C = dce.encrypt_torch(P.reshape(B * n, d), key, gen, "cuda")
    T = dce.trapgen(Qp, key, seed=d + 1)
    return (C.reshape(B, n, 4, -1).contiguous(),
            torch.as_tensor(T, device="cuda").contiguous())


def check_z(B: int, n: int, d: int, gen, single: bool = False) -> dict:
    import torch
    from repro_torch.kernels.dce_comp import dce_comp
    C, T = dce_inputs(B, n, d, gen)
    D = C.shape[-1]
    if single:
        C, T = C[0].contiguous(), T[0].contiguous()
        kern, plain = dce_comp.z_matrix, dce_comp.plain_z_matrix
    else:
        kern, plain = dce_comp.batched_z_matrix, dce_comp.plain_batched_z_matrix
    got = kern(C, T)
    want = plain(C, T)
    torch.cuda.synchronize()
    zmax = float(want.abs().max())
    err = (got - want).abs()
    sure = want.abs() > Z_RTOL * zmax
    signs_ok = bool(((got < 0) == (want < 0))[sure].all())
    if not torch.isfinite(got).all() or float(err.max()) > Z_RTOL * zmax \
            or not signs_ok:
        raise AssertionError(f"Z kernel disagrees at B={B} n={n} D={D}: "
                             f"max err {float(err.max()):.3g} of max|Z| "
                             f"{zmax:.3g}, signs ok {signs_ok}")
    exact = {}
    if single:
        # K3's split plan against the batched entry's plan (32 copies of
        # the set, unsplit): the same two fp32 chains, so bit-equal; and
        # on small integers (every sum exact) bit-equal to the plain one
        Cb32 = C[None].expand(32, -1, -1, -1).contiguous()
        Tb32 = T[None].expand(32, -1).contiguous()
        exact["equal_to_batched_entry"] = bool(torch.equal(
            got, dce_comp.batched_z_matrix(Cb32, Tb32)[5]))
        Ci = torch.randint(-8, 9, C.shape, generator=gen,
                           device="cuda").float()
        Ti = torch.randint(-3, 4, T.shape, generator=gen,
                           device="cuda").float()
        exact["equal_to_plain_on_integers"] = bool(torch.equal(
            kern(Ci, Ti), plain(Ci, Ti)))
        exact["plan"] = dce_comp.z_plan(1, n)
        if not all(v for k, v in exact.items() if k != "plan"):
            raise AssertionError(f"z_matrix at n={n} D={D} is not "
                                 f"bit-equal: {exact}")
    Cb = C if not single else C[None]
    Tb = T if not single else T[None]
    L1 = (Cb[:, :, 0] * Tb[:, None]).contiguous()
    L2 = (Cb[:, :, 1] * Tb[:, None]).contiguous()
    R3 = Cb[:, :, 2].transpose(1, 2)
    R4 = Cb[:, :, 3].transpose(1, 2)
    nb = Cb.shape[0]
    flops = 4.0 * nb * n * n * D + 2.0 * nb * n * D + nb * n * n
    nbytes = 4.0 * (nb * n * 4 * D + nb * D + nb * n * n)
    b_ms, b_by = bound(flops, nbytes)
    name = ("dce_comp.z_matrix" if single else "dce_comp.batched_z_matrix")
    shape = f"n={n},D={D}" if single else f"B={B},n={n},D={D}"
    return {
        "name": f"{name}[{shape}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/dce_comp.cu",
        "replaces": ("src/repro/kernels/dce_comp/dce_comp.py:67" if single
                     else "src/repro/kernels/dce_comp/dce_comp.py:131"),
        "max_abs_err": float(err.max()),
        "max_rel_err": float(err.max()) / zmax, **exact,
        "ms": device_ms(lambda: kern(C, T)),
        "plain_ms": device_ms(lambda: plain(C, T)),
        "library_ms": device_ms(
            lambda: torch.baddbmm(torch.bmm(L1, R3), L2, R4,
                                  beta=1.0, alpha=-1.0)),
        "library_call": "torch.baddbmm(torch.bmm(L1, R3), L2, R4, alpha=-1)"
                        " on pre-scaled L1, L2",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_refine(B: int, n: int, d: int, k: int, gen, home: str) -> dict:
    """The fused refine against its plain version (gather, Z, wins,
    stable sort) on real DCE ciphertexts read through a shuffled cand:
    ~10% of slots invalid (half of them with id -1, as the graph filter
    leaves them), query 0 with fewer valid slots than k.  The fused
    kernel's win counts must equal those of the Z entry (one main loop)
    exactly, and the plain version's wins and ids wherever every pair of
    valid slots has |Z_plain| > Z_RTOL * max|Z|; the rest is reported."""
    import torch
    from repro_torch.kernels.dce_comp import dce_comp
    from repro_torch.kernels.dce_comp.ref import batched_wins
    C, T = dce_inputs(B, n, d, gen)
    D = C.shape[-1]
    C_dce = C.reshape(B * n, 4, D)
    dev = C.device
    cand = (torch.arange(B, device=dev)[:, None] * n
            + torch.argsort(torch.rand((B, n), generator=gen, device=dev),
                            dim=1))
    valid = torch.rand((B, n), generator=gen, device=dev) > 0.1
    valid[0] = False
    valid[0, :k - 3] = True
    cand = torch.where(valid | (cand % 2 == 0), cand, -1).contiguous()
    args = (C_dce, cand, T, valid, k)
    ids, wins = dce_comp.refine_topk(*args, return_wins=True)
    ids_p, wins_p = dce_comp.plain_refine_topk(*args, return_wins=True)
    Cc = C_dce[cand]
    z_k = dce_comp.batched_z_matrix(Cc, T)
    z_p = dce_comp.plain_batched_z_matrix(Cc, T)
    torch.cuda.synchronize()
    pairs = valid[:, :, None] & valid[:, None, :] & ~torch.eye(
        n, dtype=torch.bool, device=dev)[None]
    zmax = float(z_p[pairs].abs().max())
    unsure = pairs & (z_p.abs() <= Z_RTOL * zmax)
    sure_row = ~unsure.any(-1) & valid
    sure_query = ~unsure.any(-1).any(-1)
    from_z = torch.equal(wins, batched_wins(z_k, valid))
    wins_ok = bool((wins == wins_p)[sure_row].all())
    ids_ok = bool((ids == ids_p)[sure_query].all())
    if not (from_z and wins_ok and ids_ok):
        raise AssertionError(f"fused refine disagrees at B={B} n={n} D={D}: "
                             f"wins = Z entry's {from_z}, = plain on sure "
                             f"rows {wins_ok}, ids on sure queries {ids_ok}")
    L1 = (Cc[:, :, 0] * T[:, None]).contiguous()
    L2 = (Cc[:, :, 1] * T[:, None]).contiguous()
    R3 = Cc[:, :, 2].transpose(1, 2)
    R4 = Cc[:, :, 3].transpose(1, 2)
    flops = 4.0 * B * n * n * D + 2.0 * B * n * D + B * n * n
    nbytes = 4.0 * (B * n * 4 * D + B * D) + 9.0 * B * n + 8.0 * B * k
    b_ms, b_by = bound(flops, nbytes)
    err = (z_k - z_p).abs()[pairs]
    return {
        "name": f"dce_comp.refine_topk[B={B},n={n},D={D},k={k}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/dce_comp.cu",
        "replaces": "src/repro/kernels/dce_comp/dce_comp.py:131",
        "home": home,
        "max_abs_err": float(err.max()),
        "max_rel_err": float(err.max()) / zmax,
        "wins_equal_z_entry": from_z,
        "wins_agreement": float((wins == wins_p).float().mean()),
        "id_agreement": float((ids == ids_p).float().mean()),
        "unsure_rows": int((~sure_row & valid).sum()),
        "unsure_queries": int((~sure_query).sum()),
        "invalid_slots": int((~valid).sum()),
        "ms": device_ms(lambda: dce_comp.refine_topk(*args)),
        "plain_ms": device_ms(lambda: dce_comp.plain_refine_topk(*args)),
        "library_ms": device_ms(
            lambda: torch.baddbmm(torch.bmm(L1, R3), L2, R4,
                                  beta=1.0, alpha=-1.0)),
        "library_call": "torch.baddbmm(torch.bmm(L1, R3), L2, R4, alpha=-1)"
                        " on gathered, pre-scaled L1, L2 (Z alone)",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def graph_inputs(R: int, M0: int, d: int, nq: int, gen):
    """A synthetic layer-0 graph: random ids with ~10% -1 slots, ~2% of
    rows with ok = 0, integer-valued rows and queries in [-8, 8] (every
    fp32 distance exact in any summation order), random entry points,
    and query 0 with entry -1 (an empty graph's query)."""
    import torch
    dev = torch.device("cuda")
    C = torch.randint(-8, 9, (R, d), generator=gen, device=dev).float()
    Q = torch.randint(-8, 9, (nq, d), generator=gen, device=dev).float()
    neigh0 = torch.randint(0, R, (R, M0), generator=gen, device=dev,
                           dtype=torch.int32)
    neigh0[torch.rand((R, M0), generator=gen, device=dev) < 0.1] = -1
    ok = torch.rand(R, generator=gen, device=dev) > 0.02
    ep = torch.randint(0, R, (nq,), generator=gen, device=dev)
    ep[0] = -1
    ep_d = ((C[ep.clamp(min=0)] - Q) ** 2).sum(-1)
    ep_d = torch.where(ep >= 0, ep_d, float("inf"))
    return neigh0, ok, C, Q, ep, ep_d


def graph_expand_bound(hops, edges, R: int, M0: int, d: int, ef_cap: int,
                       up_hops=None, up_edges=None,
                       M: int = 0) -> tuple[float, str]:
    """K6's bound from what this run's walks needed: per layer-0 hop the
    M0 ids of the expanded row; per scored edge (a fresh neighbour:
    valid, ok, not yet visited) its row of d floats and its ok flag, and
    3d fp32 operations (sub, mul, add); once per query its query row and
    entry point; and the outputs (beam ids and distances, hops, edges and
    the visited words).  Padding slots, rows with ok = 0 and neighbours
    already visited need no row.  With the upper layers' steps (up_hops,
    up_edges: valid neighbours scored), M ids a step and the same per
    edge."""
    nq = hops.shape[0]
    n_hops, n_edges = int(hops.sum()), int(edges.sum())
    u_hops = int(up_hops.sum()) if up_hops is not None else 0
    u_edges = int(up_edges.sum()) if up_edges is not None else 0
    nbytes = (n_hops * M0 * 4.0 + u_hops * M * 4.0
              + (n_edges + u_edges) * (4.0 * d + 1.0)
              + nq * (4.0 * d + 8.0)
              + nq * (ef_cap * 8.0 + 8.0 + ((R + 31) // 32) * 4.0))
    return bound((n_edges + u_edges) * 3.0 * d, nbytes)


def check_graph_expand(R: int, M0: int, d: int, gen, nq: int = BATCH,
                       ef: int = 96, ef_cap: int = 128,
                       max_hops: int = 512) -> dict:
    """K6's layer-0 entry against its plain version (integer-valued
    rows: bit-equal ids, distances, visited, hops and edges); the defaults
    are the graph path's beam plan (k' 80, ef_search 96: ef 96, ef_cap
    128, max_hops 512)."""
    import torch
    from repro_torch.kernels.graph_expand import graph_expand
    args = graph_inputs(R, M0, d, nq, gen)
    kw = dict(ef=ef, ef_cap=ef_cap, max_hops=max_hops)
    got = graph_expand.expand_layer0(*args, **kw)
    want = graph_expand.plain_expand_layer0(*args, **kw)
    torch.cuda.synchronize()
    same = got[0] == want[0]
    agree = float(same.float().mean())
    fin = same & torch.isfinite(want[1])
    err = (got[1] - want[1]).abs()[fin]
    rel = err / want[1].abs()[fin].clamp_min(1e-30)
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float(rel.max()) if rel.numel() else 0.0
    names = ("ids", "distances", "visited", "hops", "edges")
    bad = [nm for nm, g, w in zip(names, got, want)
           if g.dtype != w.dtype or not torch.equal(g, w)]
    if bad:
        raise AssertionError(f"graph_expand differs from its plain version "
                             f"at R={R} M0={M0} d={d}: {bad} (ids equal in "
                             f"{agree} of slots, max rel err {max_rel})")
    hops, edges = got[3], got[4]
    b_ms, b_by = graph_expand_bound(hops, edges, R, M0, d, ef_cap)
    ms = device_ms(lambda: graph_expand.expand_layer0(*args, **kw))
    return {
        "name": f"graph_expand.expand_layer0[nq={nq},R={R},M0={M0},d={d}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/graph_expand.cu",
        "replaces": "src/repro/kernels/graph_expand/graph_expand.py:234",
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "beam_slot_id_agreement": agree, "bit_equal": True,
        "max_hops_per_query": int(hops.max()),
        "mean_hops_per_query": float(hops.float().mean()),
        "mean_edges_per_query": float(edges.float().mean()),
        "ms": ms, "us_per_hop": 1e3 * ms / max(1, int(hops.max())),
        "plain_ms": device_ms(
            lambda: graph_expand.plain_expand_layer0(*args, **kw),
            reps=10, warmup=2),
        "library_ms": None, "library_call": "none (no PyTorch call runs "
                                            "a beam search)",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def walk_inputs(R: int, M0: int, M: int, LU: int, d: int, nq: int, gen,
                empty_top: int = 3):
    """`graph_inputs`' layer 0 under LU upper layers: the top `empty_top`
    padded with -1 rows only, the others M random ids (~10% -1) on nested
    node sets of R / 4^(li+1) rows, all holding the entry (an ok row)."""
    import torch
    dev = torch.device("cuda")
    neigh0, ok, C, Q, _, _ = graph_inputs(R, M0, d, nq, gen)
    perm = torch.randperm(R, generator=gen, device=dev)
    up = torch.full((LU, R, M), -1, dtype=torch.int32, device=dev)
    for li in range(LU - empty_top):
        nodes = perm[: max(2, R >> (2 * li + 2))]
        pick = torch.randint(0, nodes.numel(), (nodes.numel(), M),
                             generator=gen, device=dev)
        rows = nodes[pick].int()
        rows[torch.rand(rows.shape, generator=gen, device=dev) < 0.1] = -1
        up[li, nodes] = rows
    entry = int(perm[0])
    ok[entry] = True
    return neigh0, up.contiguous(), ok, C, Q, entry


def check_graph_walk(R: int, M0: int, M: int, LU: int, d: int, gen,
                     nq: int = BATCH, ef: int = 96, ef_cap: int = 128,
                     max_hops: int = 512) -> dict:
    """The fused walk against its plain version (the torch walk) on a
    synthetic graph with upper layers (3 of them empty) over
    integer-valued rows: every distance is exact in any summation order,
    so ids, distances, visited words, hops and edges must be bit-equal.
    The defaults are the graph path's beam plan."""
    import torch
    from repro_torch.graph import traverse
    from repro_torch.kernels.graph_expand import graph_expand
    n0, up, ok, C, Q, entry = walk_inputs(R, M0, M, LU, d, nq, gen)
    kw = dict(ef_cap=ef_cap, max_hops=max_hops)
    args = (n0, up, ok, C, Q, entry, ef)
    got = graph_expand.graph_walk(*args, **kw)
    want = graph_expand.plain_graph_walk(*args, **kw)
    torch.cuda.synchronize()
    names = ("ids", "distances", "visited", "hops", "edges")
    bad = [nm for nm, g, w in zip(names, got, want)
           if g.dtype != w.dtype or not torch.equal(g, w)]
    G, pool, svis = graph_expand.walk_plan(R, M0, M, d, ef)
    smem = graph_expand.walk_smem(ef, M0, M, d, G, pool, svis, R)
    if graph_expand.walk_smem_on_card(ef, M0, M, d, G, pool, svis, R) != smem:
        bad.append("shared-memory plan")
    if bad:
        raise AssertionError(f"graph_walk differs from the torch walk at "
                             f"R={R} M0={M0} M={M} d={d} ef={ef}: {bad}")
    hops, edges = got[3], got[4]
    _, _, up_hops, up_edges = traverse.upper_entry(up, ok, (C,), Q, entry)
    b_ms, b_by = graph_expand_bound(hops - up_hops, edges - up_edges, R,
                                    M0, d, ef_cap, up_hops, up_edges, M)
    ms = device_ms(lambda: graph_expand.graph_walk(*args, **kw))
    return {
        "name": f"graph_expand.graph_walk[nq={nq},R={R},M0={M0},M={M},"
                f"LU={LU},d={d},ef={ef},ef_cap={ef_cap}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/graph_expand.cu",
        "replaces": "src/repro/kernels/graph_expand/graph_expand.py:234",
        "also_replaces": "src/repro/graph/traverse.py:141",
        "max_abs_err": 0.0, "bit_equal": True,
        "plan": {"rows_a_group": G, "adjacency_pool": pool,
                 "visited_on_chip": svis, "shared_bytes": smem},
        "max_hops_per_query": int(hops.max()),
        "mean_hops_per_query": float(hops.float().mean()),
        "mean_upper_hops_per_query": float(up_hops.float().mean()),
        "mean_edges_per_query": float(edges.float().mean()),
        "ms": ms, "us_per_hop": 1e3 * ms / int(hops.max()),
        "plain_ms": device_ms(lambda: graph_expand.plain_graph_walk(
            *args, **kw), reps=5, warmup=1),
        "library_ms": None, "library_call": "none (no PyTorch call runs "
                                            "a graph walk)",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def adc_valid_rows(n: int, gen, n_valid: int | None = None):
    """Row validity: about 1% of rows masked, or exactly n_valid valid."""
    import torch
    if n_valid is None:
        return torch.rand(n, generator=gen, device="cuda") > 0.01
    ok = torch.zeros(n, dtype=torch.bool, device="cuda")
    ok[torch.randperm(n, generator=gen, device="cuda")[:n_valid]] = True
    return ok


def adc_outputs_equal(got, want, what: str) -> float:
    """Exact equality of ids and distances (bit-equal floats); returns
    the largest |distance difference| (0)."""
    import torch
    torch.cuda.synchronize()
    same_i = torch.equal(got[1], want[1])
    same_d = torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    if not (same_i and same_d and got[0].dtype == want[0].dtype):
        agree = float((got[1] == want[1]).float().mean())
        raise AssertionError(f"{what} disagrees with its plain version: ids "
                             f"equal in {agree} of slots, dists bit-equal "
                             f"{same_d}")
    return float((got[0].double() - want[0].double()).abs().max())


def adc_split(name: str, call, masked, reps: int = 20) -> dict:
    """Device time of a fused ADC call split into scan, selection and
    merge (torch.profiler, by kernel: the scan kernel and the merge
    kernel).  `masked` is the same call with every row masked: its scan
    kernel stages the codes and computes every distance but offers no key,
    so its time is the scan alone and the rest of the scan kernel's time
    with the rows as given is the selection."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    def by_kernel(fn) -> dict:
        events = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=reps),
                     on_trace_ready=lambda p: events.extend(p.key_averages())
                     ) as prof:
            for _ in range(reps + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        out = {}                # ms a launch, over the launches it saw
        for stage in ("scan", "merge"):
            seen = [ev for ev in events
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and f"{stage}_kernel" in ev.key and ev.count > 0
                    and getattr(ev, "self_device_time_total", 0) > 0]
            if seen:
                out[stage] = (sum(ev.self_device_time_total for ev in seen)
                              / 1e3 / sum(ev.count for ev in seen))
        if set(out) != {"scan", "merge"}:
            raise AssertionError(f"{name}: the profiler saw {out}, not the "
                                 f"scan and merge kernels")
        return out
    real, alone = by_kernel(call), by_kernel(masked)
    return {"phase": "adc_split", "kernel": name, "reps": reps,
            "scan_kernel_ms": real["scan"], "scan_ms": alone["scan"],
            "selection_ms": real["scan"] - alone["scan"],
            "merge_ms": real["merge"], "merge_ms_rows_masked": alone["merge"]}


def check_sq_adc(nq: int, n: int, d: int, kp: int, gen,
                 n_valid: int | None = None,
                 home: str | None = None) -> dict:
    """K4 against its plain version: random int8 codes (the last 1% of
    rows repeat the first, so exact ties between distinct ids occur),
    their norms, ~1% of rows masked (or exactly n_valid valid)."""
    import torch
    from repro_torch.kernels.adc_topk import adc_topk
    dev = torch.device("cuda")
    q8 = torch.randint(-127, 128, (nq, d), generator=gen, device=dev,
                       dtype=torch.int8)
    c8 = torch.randint(-127, 128, (n, d), generator=gen, device=dev,
                       dtype=torch.int8)
    dup = n // 100
    if dup:
        c8[n - dup:] = c8[:dup]
    cn = (c8.to(torch.int32) ** 2).sum(1, dtype=torch.int32)
    ok = adc_valid_rows(n, gen, n_valid)
    args = (q8, c8, cn, ok, kp)
    got = adc_topk.sq_adc_topk(*args)
    want = adc_topk.plain_sq_adc_topk(*args)
    err = adc_outputs_equal(got, want, f"sq_adc_topk at nq={nq} n={n} d={d}")
    kpp = min(kp, n)
    nbytes = nq * d + n * d + 4.0 * n + n + 12.0 * nq * kpp
    b_ms, b_by = bound(2.0 * nq * n * d, nbytes, PEAK_INT8_OPS)
    rec = {
        "name": f"adc_topk.sq_adc_topk[nq={nq},n={n},d={d},kp={kp}"
                + (f",valid={n_valid}]" if n_valid is not None else "]"),
        "route": "cuda",
        "source": "src/repro_torch/csrc/adc_topk.cu",
        "replaces": "src/repro/kernels/adc_topk/adc_topk.py:192",
        "max_abs_err": err, "id_agreement": 1.0,
        "empty_slots": int((got[1] < 0).sum()),
        "ms": device_ms(lambda: adc_topk.sq_adc_topk(*args)),
        "plain_ms": device_ms(lambda: adc_topk.plain_sq_adc_topk(*args),
                              reps=10, warmup=2),
        "bound_ms": b_ms, "bound_by": b_by,
        **({"home": home} if home else {}),
    }
    none = torch.zeros_like(ok)
    log(json.dumps(adc_split(
        rec["name"], lambda: adc_topk.sq_adc_topk(*args),
        lambda: adc_topk.sq_adc_topk(q8, c8, cn, none, kp))))
    c8t = c8.T
    big = adc_topk.INT_BIG

    def library():
        d_ = cn[None, :] - 2 * torch._int_mm(q8, c8t)
        return torch.topk(torch.where(ok[None, :], d_, big), kpp, dim=1,
                          largest=False)
    try:
        library()
        rec["library_ms"] = device_ms(library)
        rec["library_call"] = ("torch._int_mm(q8, c8.T), cn - 2 cross, "
                               "torch.topk(largest=False)")
    except RuntimeError as exc:          # _int_mm refuses some shapes
        rec["library_ms"] = None
        rec["library_call"] = f"none: torch._int_mm refused ({exc})"[:200]
    return rec


def check_pq_adc(nq: int, m: int, n: int, kp: int, gen,
                 home: str | None = None) -> dict:
    """K5 against its plain version: random tables (half of the entries
    integer-valued, so equal sums occur) and codes, ~1% of rows masked."""
    import torch
    from repro_torch.kernels.adc_topk import adc_topk
    dev = torch.device("cuda")
    lut = 100.0 * torch.rand((nq, m, 256), generator=gen, device=dev)
    lut[:, :, ::2] = lut[:, :, ::2].round()
    codes_t = torch.randint(0, 256, (m, n), generator=gen, device=dev,
                            dtype=torch.uint8)
    ok = adc_valid_rows(n, gen)
    args = (lut, codes_t, ok, kp)
    got = adc_topk.pq_adc_topk(*args)
    want = adc_topk.plain_pq_adc_topk(*args)
    err = adc_outputs_equal(got, want, f"pq_adc_topk at nq={nq} m={m} n={n}")
    kpp = min(kp, n)
    nbytes = m * n + n + 4.0 * nq * m * 256 + 12.0 * nq * kpp
    b_ms, b_by = bound(float(nq) * n * m, nbytes)
    name = f"adc_topk.pq_adc_topk[nq={nq},m={m},n={n},kp={kp}]"
    none = torch.zeros_like(ok)
    log(json.dumps(adc_split(
        name, lambda: adc_topk.pq_adc_topk(*args),
        lambda: adc_topk.pq_adc_topk(lut, codes_t, none, kp))))
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/csrc/adc_topk.cu",
        "replaces": "src/repro/kernels/adc_topk/adc_topk.py:249",
        "max_abs_err": err, "id_agreement": 1.0,
        "ms": device_ms(lambda: adc_topk.pq_adc_topk(*args)),
        "plain_ms": device_ms(lambda: adc_topk.plain_pq_adc_topk(*args),
                              reps=10, warmup=2),
        "library_ms": None,
        "library_call": "none (no PyTorch call sums table look-ups and "
                        "selects the top-k in one)",
        "bound_ms": b_ms, "bound_by": b_by,
        **({"home": home} if home else {}),
    }


# --------------------------------------------------------------- phase 3

def run_batches(eng, Q, T, stats=None):
    ids, lat = [], []
    for s in range(0, Q.shape[0], BATCH):
        t0 = time.perf_counter()
        out, st = eng.search_batch(Q[s:s + BATCH], T[s:s + BATCH], K,
                                   ratio_k=RATIO_K, ef_search=EF_SEARCH)
        lat.append(time.perf_counter() - t0)      # ids are on the host
        ids.append(out)
        if stats is not None:
            stats.append(st)
    return np.concatenate(ids), lat


def k1600_path(eng, Q, T, k: int, path: str, n_batches: int = 4):
    """`n_batches` batches of 32 at ratio_k 8 and a k that makes 1600
    candidates (the flat filter's k' = 8 k; int8 and pq8 oversample by 2
    and 4), above the fused top-k kernels' 1024 a pass: once through the
    kernels, once with them swapped for their plain versions.  The
    filter's candidate ids must be equal: K4 and K5 are bit-equal, slot
    for slot; K1 sums in another fp32 order, which may swap neighbours
    within an ulp of each other, so its candidates are held as each
    query's set (>= 99.9% of them).  The final ids, after the refine,
    must agree in >= 99.9% of slots.  -> the launches."""
    import torch
    f = eng.backend
    kp = k * RATIO_K
    batches = [(Q[s:s + BATCH], T[s:s + BATCH])
               for s in range(0, n_batches * BATCH, BATCH)]
    eng.search_batch(*batches[0], k, ratio_k=RATIO_K)          # warm-up

    def run():
        ids, lat, cands = [], [], []
        for Qb, Tb in batches:
            t0 = time.perf_counter()
            out, _ = eng.search_batch(Qb, Tb, k, ratio_k=RATIO_K)
            lat.append(time.perf_counter() - t0)
            ids.append(out)
        for Qb, _ in batches:
            cands.append(f.candidates(np.asarray(Qb, np.float32), kp,
                                      EF_SEARCH)[0])
        torch.cuda.synchronize()
        return np.concatenate(ids), lat, torch.cat(cands)

    reset_launches()
    ids, lat, cand = run()
    launches = kernel_launches()
    with plain_kernels():
        ids_p, lat_p, cand_p = run()
    if kernel_launches() != launches:
        raise AssertionError("a kernel launched during the plain run")
    exact = f.name != "flat"
    if exact:
        cand_agree = float((cand == cand_p).float().mean())
    else:
        cand_agree = float(sum(torch.isin(a, b).sum() for a, b in
                               zip(cand, cand_p))) / cand.numel()
    agree = float((ids == ids_p).mean())
    rec = {"phase": "k1600", "path": path, "k": k,
           "candidates_per_query": int(cand.shape[1]),
           "batches": n_batches, "candidate_id_agreement": cand_agree,
           "candidates_compared_as": "slots" if exact else "sets",
           "id_agreement": agree,
           "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
           "batch_p50_ms_plain": float(np.percentile(lat_p, 50)) * 1e3,
           "launches_per_batch": {kk: v / n_batches
                                  for kk, v in launches.items() if v}}
    log(json.dumps(rec))
    if (cand.shape[1] != 1600 or agree < MIN_ID_AGREEMENT
            or cand_agree < (1.0 if exact else MIN_ID_AGREEMENT)):
        raise AssertionError(f"{path} at k' 1600: candidates "
                             f"{cand.shape[1]}, candidate ids "
                             f"{cand_agree}, final ids {agree}")
    return launches


def profile_batches(eng, Q, T, n_batches: int = 2) -> dict:
    """Device time by kernel over a short window of main-path batches
    (torch.profiler), and the device's busy share of that window.  One
    batch runs first as the profiler's warm-up step: the tracer loses
    activity at its start, which on a path of few kernels a batch can be
    a whole batch.  The profiler's own host cost lengthens the window,
    so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    events = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_batches),
                 on_trace_ready=lambda p: events.extend(p.key_averages())
                 ) as prof:
        for i in range(n_batches + 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            s = i * BATCH % Q.shape[0]
            eng.search_batch(Q[s:s + BATCH], T[s:s + BATCH], K,
                             ratio_k=RATIO_K, ef_search=EF_SEARCH)
            if i == n_batches:
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    kernels = []
    for ev in events:
        dev_us = getattr(ev, "self_device_time_total", 0)
        if (ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0
                and not ev.key.startswith("ProfilerStep")):   # step ranges
            kernels.append((dev_us / 1e3 / n_batches, ev.count / n_batches,
                            ev.key[:60]))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return {
        "phase": "profile", "batches": n_batches,
        "device_busy_ms_per_batch": busy_ms if kernels else None,
        "profiled_wall_ms_per_batch": wall_ms / n_batches,
        "device_idle_share_upper_bound":
            1 - busy_ms * n_batches / wall_ms if kernels else None,
        "top_kernels_ms_per_batch": [
            {"kernel": name, "ms": ms, "launches": cnt}
            for ms, cnt, name in kernels[:8]],
    }


def small_reference_check():
    """The card's engines against the host's plain versions on a small
    database encrypted by the numpy path, through the filters of every
    ported path (f32 flat and IVF, ADC flat and IVF in int8 and pq8, the
    graph filter in f32, int8 and pq8): the ids must agree."""
    from repro_torch.core import dcpe, ppanns
    from repro_torch.core.hnsw import HNSW
    from repro_torch.data import synth
    from repro_torch.graph import GraphFilter
    from repro_torch.serving.search_engine import SecureSearchEngine
    ds = synth.make_dataset("sift1m", n=3000, n_queries=32, k_gt=K, seed=5)
    owner = ppanns.DataOwner(d=ds.d, sap_beta=dcpe.suggest_beta(
        ds.base, 0.03), seed=5)
    db = owner.encrypt_database(ds.base, build_index=False)
    user = ppanns.User(owner.share_keys())
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    index = HNSW(ds.d, M=GRAPH_M, ef_construction=GRAPH_EF_CONSTRUCTION,
                 seed=8).build(db.C_sap)
    ivf = dict(n_partitions=IVF_PARTITIONS, nprobe=IVF_NPROBE)
    filters = {      # engine arguments, made anew for each engine
        "flat": lambda: {},
        "ivf": lambda: dict(backend="ivf", **ivf),
        "adc-flat-int8": lambda: dict(quantization="int8"),
        "adc-flat-pq8": lambda: dict(quantization="pq8"),
        "adc-ivf-int8": lambda: dict(backend="ivf", quantization="int8",
                                     **ivf),
        "adc-ivf-pq8": lambda: dict(backend="ivf", quantization="pq8",
                                    **ivf),
        "graph": lambda: dict(backend=GraphFilter(index)),
        "adc-graph-int8": lambda: dict(
            backend=GraphFilter(index, quantization="int8")),
        "adc-graph-pq8": lambda: dict(
            backend=GraphFilter(index, quantization="pq8")),
    }
    out = {}
    for name, kw in filters.items():
        got, _ = SecureSearchEngine(db.C_sap, db.C_dce, **kw()).search_batch(
            Q, T, K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        want, _ = SecureSearchEngine(db.C_sap, db.C_dce, device="cpu",
                                     **kw()).search_batch(
            Q, T, K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        out[name] = {"id_agreement_card_vs_host":
                     float((got == want).mean()),
                     "recall@10": synth.recall_at_k(got, ds.gt, K)}
    log(json.dumps({"phase": "small_reference", "n": ds.n,
                    "queries": Q.shape[0], "filters": out}))
    bad = {k: v for k, v in out.items()
           if v["id_agreement_card_vs_host"] < MIN_ID_AGREEMENT}
    if bad:
        raise AssertionError(f"card and host ids disagree: {bad}")


def main_path(n: int, n_queries: int) -> dict:
    import torch
    from repro_torch.core import dcpe, ppanns
    from repro_torch.data import synth
    from repro_torch.serving.search_engine import SecureSearchEngine

    t0 = time.perf_counter()
    ds = synth.make_dataset("sift1m", n=n, n_queries=n_queries, k_gt=K)
    t_data = time.perf_counter() - t0
    owner = ppanns.DataOwner(d=ds.d, sap_beta=dcpe.suggest_beta(
        ds.base, 0.03))
    t0 = time.perf_counter()
    C_sap, C_dce = owner.encrypt_vectors(ds.base)          # on the card
    t_enc = time.perf_counter() - t0
    user = ppanns.User(owner.share_keys())
    t0 = time.perf_counter()
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    t_query_enc = time.perf_counter() - t0
    log(json.dumps({"phase": "setup", "n": ds.n, "d": ds.d,
                    "queries": Q.shape[0], "dataset_s": t_data,
                    "encrypt_vectors_s": t_enc, "encrypt_rows_per_s":
                    ds.n / t_enc, "user_encrypt_queries_s": t_query_enc}))

    eng = SecureSearchEngine(C_sap, C_dce, backend="flat")   # device: card
    t0 = time.perf_counter()
    eng.search_batch(Q[:BATCH], T[:BATCH], K, ratio_k=RATIO_K)   # upload
    t_warm = time.perf_counter() - t0

    reset_launches()
    ids, lat = run_batches(eng, Q, T)
    launches = kernel_launches()
    resident = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()

    with plain_kernels():
        ids_plain, lat_plain = run_batches(eng, Q, T)
    if kernel_launches() != launches:
        raise AssertionError("a kernel launched during the plain run")

    log(json.dumps(profile_batches(eng, Q, T)))

    rec = synth.recall_at_k(ids, ds.gt, K)
    rec_plain = synth.recall_at_k(ids_plain, ds.gt, K)
    agree = float((ids == ids_plain).mean())
    total = sum(lat)
    out = {
        "phase": "main_path", "n": ds.n, "d": ds.d, "queries": Q.shape[0],
        "batch": BATCH, "k": K, "k_prime": K * RATIO_K,
        "recall@10": rec, "recall@10_plain": rec_plain,
        "id_agreement": agree,
        "qps": Q.shape[0] / total,
        "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "batch_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "qps_plain": Q.shape[0] / sum(lat_plain),
        "batch_p50_ms_plain": float(np.percentile(lat_plain, 50)) * 1e3,
        "batch_p99_ms_plain": float(np.percentile(lat_plain, 99)) * 1e3,
        "first_batch_with_upload_s": t_warm,
        "device_resident_bytes": resident, "device_peak_bytes": peak,
        "launches": launches,
    }
    log(json.dumps(out))
    if ids.shape != (Q.shape[0], K) or (ids < 0).any() or (ids >= n).any():
        raise AssertionError("main path returned ids outside the database")
    nb = len(lat)
    if (launches["l2_topk.knn"] != nb
            or launches["dce_comp.refine_topk"] != nb):
        raise AssertionError(f"flat path kernels: {launches} for {nb} "
                             f"batches (one fused scan and one fused "
                             f"refine a batch)")
    if agree < MIN_ID_AGREEMENT or abs(rec - rec_plain) > MAX_RECALL_GAP:
        raise AssertionError(f"kernel and plain runs disagree: ids "
                             f"{agree}, recall {rec} vs {rec_plain}")
    on_k1600 = k1600_path(eng, Q, T, 200, "flat_k1600")
    # the ADC paths search the same ciphertexts and queries
    return launches, on_k1600, {"ds": ds, "C_sap": C_sap, "C_dce": C_dce,
                                "Q": Q, "T": T, "ids": ids,
                                "keys": owner.keys}


# --------------------------------------------------------------- phase 4

@contextlib.contextmanager
def timed_codebook(out: dict):
    """Host seconds of an ADC filter's codebook training and of encoding
    the corpus with it (wrapped around the filter's attach)."""
    from repro_torch.core import adc
    train = adc.train_codebook
    encodes = {cls: cls.encode for cls in (adc.SQCodebook, adc.PQCodebook)}

    def timed_train(*a, **kw):
        t0 = time.perf_counter()
        book = train(*a, **kw)
        out["codebook_train_s"] = time.perf_counter() - t0
        return book

    def timed(encode):
        def timed_encode(self, C):
            t0 = time.perf_counter()
            codes = encode(self, C)
            out["codebook_encode_s"] = time.perf_counter() - t0
            return codes
        return timed_encode
    adc.train_codebook = timed_train
    for cls, encode in encodes.items():
        cls.encode = timed(encode)
    try:
        yield
    finally:
        adc.train_codebook = train
        for cls, encode in encodes.items():
            cls.encode = encode


def adc_breakdown(eng, Q, T, reps: int = 10) -> dict:
    """Host-clock time of one flat ADC batch and of its stages run alone
    on the same queries (each ended by a synchronize; medians of reps):
    the filter, the query operand that the codebook makes on the host
    (int8 codes or the PQ tables) with its upload, the fused kernel, and
    the refine of the filter's candidates; and the device time of the
    kernel and of the refine."""
    import torch
    from repro_torch.kernels.adc_topk import ops as adc_ops
    from repro_torch.serving.search_engine import refine_candidates
    f = eng.backend
    Qb = np.asarray(Q[:BATCH], np.float32)
    kp = K * RATIO_K
    kp2 = min(f.oversampled(kp), f._n)
    dev = f._ok.device
    qop = f._query_operand(Qb, dev)
    if f.quantization == "int8":
        kernel = lambda: adc_ops.sq_knn(qop, f._c8, f._cn, kp2, ok=f._ok)
    else:
        kernel = lambda: adc_ops.pq_knn(qop, f._codes_t, kp2, ok=f._ok)
    cand, valid, _ = f.candidates(Qb, kp, EF_SEARCH)
    Tq = torch.as_tensor(np.asarray(T[:BATCH], np.float32)).to(dev)
    refine = lambda: refine_candidates(eng._C_dce_dev, cand, Tq, valid, K)
    return {
        "phase": "adc_breakdown", "backend": f.name, "batch": BATCH,
        "reps": reps,
        "search_batch_ms": host_ms(lambda: eng.search_batch(
            Q[:BATCH], T[:BATCH], K, ratio_k=RATIO_K), reps),
        "filter_candidates_ms": host_ms(
            lambda: f.candidates(Qb, kp, EF_SEARCH), reps),
        "query_operand_ms": host_ms(lambda: f._query_operand(Qb, dev), reps),
        "kernel_ms": host_ms(kernel, reps),
        "kernel_device_ms": device_ms(kernel),
        "refine_ms": host_ms(refine, reps),
        "refine_device_ms": device_ms(refine),
    }


def adc_path(ctx: dict, quantization: str, backend: str = "flat") -> dict:
    """The quantized filter on the flat path's ciphertexts and queries:
    `SecureSearchEngine(backend=..., quantization=...)` on the card, once
    through the kernels and once with them swapped for their plain
    versions on the same engine, so the codebook is trained once."""
    import torch
    from repro_torch.data import synth
    from repro_torch.serving.search_engine import SecureSearchEngine
    ds, Q, T = ctx["ds"], ctx["Q"], ctx["T"]
    ivf = backend == "ivf"
    path = f"ivf_{quantization}" if ivf else f"adc_{quantization}"
    kw = dict(n_partitions=IVF_PARTITIONS, nprobe=IVF_NPROBE) if ivf else {}
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    eng = SecureSearchEngine(ctx["C_sap"], ctx["C_dce"], backend=backend,
                             quantization=quantization, **kw)   # the card
    wall = {}
    t0 = time.perf_counter()
    with timed_codebook(wall):
        eng._ensure_attached()           # codebook, codes, C_DCE upload
    wall["attach_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.search_batch(Q[:BATCH], T[:BATCH], K, ratio_k=RATIO_K)
    wall["first_batch_s"] = time.perf_counter() - t0

    reset_launches()
    stats = []
    ids, lat = run_batches(eng, Q, T, stats)
    launches = kernel_launches()
    resident = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    nq, nb = Q.shape[0], len(lat)
    rec = synth.recall_at_k(ids, ds.gt, K)
    totals = {f: int(sum(getattr(st, f) for st in stats))
              for f in ("filter_dist_evals", "filter_bytes_scanned",
                        "refine_comparisons")}
    out = {
        "phase": "adc_path", "path": path, "backend": eng.backend.name,
        "n": ds.n, "d": ds.d, "queries": nq, "batch": BATCH, "k": K,
        "k_prime": K * RATIO_K,
        "candidates_refined_per_query": eng.backend.oversampled(K * RATIO_K),
        "recall@10": rec,
        "qps": nq / sum(lat),
        "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "batch_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "search_stats": totals,
        "filter_bytes_per_row_per_batch":
            totals["filter_bytes_scanned"] / (nb * ds.n),
        "launches": launches,
        "launches_per_batch": {k: v / nb for k, v in launches.items()},
        "device_resident_bytes": resident - before,
        "device_peak_bytes": peak - before,
        "wall_s": wall,
    }
    if ivf:
        out.update(n_partitions=IVF_PARTITIONS, nprobe=IVF_NPROBE)
    with plain_kernels():
        ids_plain, lat_plain = run_batches(eng, Q, T)
    if kernel_launches() != launches:
        raise AssertionError("a kernel launched during the plain run")
    rec_plain = synth.recall_at_k(ids_plain, ds.gt, K)
    agree = float((ids == ids_plain).mean())
    out.update({
        "recall@10_plain": rec_plain, "id_agreement": agree,
        "qps_plain": nq / sum(lat_plain),
        "batch_p50_ms_plain": float(np.percentile(lat_plain, 50)) * 1e3,
        "batch_p99_ms_plain": float(np.percentile(lat_plain, 99)) * 1e3,
    })
    log(json.dumps(dict(profile_batches(eng, Q, T, n_batches=4), path=path)))
    if not ivf:                          # the breakdown times the flat scan
        log(json.dumps(adc_breakdown(eng, Q, T)))
    log(json.dumps(out))
    if ids.shape != (nq, K) or (ids < 0).any() or (ids >= ds.n).any():
        raise AssertionError(f"{path} returned ids outside the database")
    kern = ("adc_topk.sq_adc_topk" if quantization == "int8"
            else "adc_topk.pq_adc_topk")
    if (launches["dce_comp.refine_topk"] != nb
            or (not ivf and launches[kern] != nb)):
        raise AssertionError(f"{path} kernels: {launches} for {nb} batches")
    if agree < MIN_ID_AGREEMENT or abs(rec - rec_plain) > MAX_RECALL_GAP:
        raise AssertionError(f"{path}: kernel and plain runs disagree: ids "
                             f"{agree}, recall {rec} vs {rec_plain}")
    if ivf:
        return launches, None
    return launches, k1600_path(eng, Q, T, {"int8": 100, "pq8": 50}[
        quantization], f"{path}_k1600")


# --------------------------------------------------------------- phase 5

def build_hnsw(C_sap: np.ndarray, M: int, ef_construction: int, seed: int):
    """Worker process: the owner's HNSW build over C_SAP (host numpy),
    and its seconds."""
    from repro_torch.core.hnsw import HNSW
    t0 = time.perf_counter()
    index = HNSW(C_sap.shape[1], M=M, ef_construction=ef_construction,
                 seed=seed).build(C_sap)
    return index, time.perf_counter() - t0


def graph_setup(n: int, n_queries: int, pool) -> dict:
    """The graph path's corpus and queries, encrypted on the card, and
    the HNSW build over C_SAP started in `pool`."""
    from repro_torch.core import dcpe, ppanns
    from repro_torch.data import synth
    t0 = time.perf_counter()
    ds = synth.make_dataset("sift1m", n=n, n_queries=n_queries, k_gt=K)
    t_data = time.perf_counter() - t0
    owner = ppanns.DataOwner(d=ds.d, sap_beta=dcpe.suggest_beta(
        ds.base, 0.03), seed=OWNER_SEED)
    t0 = time.perf_counter()
    C_sap, C_dce = owner.encrypt_vectors(ds.base)          # on the card
    t_enc = time.perf_counter() - t0
    build = pool.apply_async(build_hnsw, (C_sap, GRAPH_M,
                                          GRAPH_EF_CONSTRUCTION,
                                          OWNER_SEED + 3))
    # 1,000 rows more from the same mixture (same seed: the same cluster
    # centres), encrypted with the same keys: the graph runtime's inserts
    extra = synth.make_dataset("sift1m", n=n + 1000, n_queries=1,
                               k_gt=1).base[n:]
    extra_sap, extra_dce = owner.encrypt_vectors(extra)
    # query 0's plaintext as a row: phase 7's insert after a reload
    probe_sap, probe_dce = owner.encrypt_vectors(ds.queries[:1])
    user = ppanns.User(owner.share_keys())
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    log(json.dumps({"phase": "graph_setup", "n": ds.n, "d": ds.d,
                    "queries": Q.shape[0], "dataset_s": t_data,
                    "encrypt_vectors_s": t_enc, "hnsw_M": GRAPH_M,
                    "hnsw_ef_construction": GRAPH_EF_CONSTRUCTION}))
    return {"ds": ds, "C_sap": C_sap, "C_dce": C_dce, "Q": Q, "T": T,
            "extra_sap": extra_sap, "extra_dce": extra_dce,
            "probe_sap": probe_sap, "probe_dce": probe_dce,
            "build": build, "t_data": t_data, "t_enc": t_enc}


def graph_index(g: dict):
    """The owner's HNSW from the worker, waited for by its first user
    (phase 6's graph collection): -> (index, build seconds); the seconds
    waited go to g["t_wait"]."""
    if "index" not in g:
        t0 = time.perf_counter()
        g["index"], g["build_s"] = g["build"].get()
        g["t_wait"] = time.perf_counter() - t0
    return g["index"], g["build_s"]


@contextlib.contextmanager
def recorded_walks(out: list):
    """Keep each batch's per-query hop and edge counts (device tensors,
    no sync) from the graph walk's entry point."""
    from repro_torch.kernels.graph_expand import ops as graph_ops
    inner = graph_ops.graph_topk

    def record(*a, **kw):
        res = inner(*a, **kw)
        out.append((res[3], res[4]))
        return res
    graph_ops.graph_topk = record
    try:
        yield
    finally:
        graph_ops.graph_topk = inner


def graph_breakdown(eng, Q, T, reps: int = 10) -> dict:
    """Host-clock time of one graph batch and of its parts run alone on
    the same queries (each ended by a synchronize; medians of `reps`):
    the filter, the fused walk (one graph_walk launch), the scan trace's
    download (the (nq, R) bool trace that the filter downloads, and the
    alternative: the kernel's packed words, 32x fewer bytes, unpacked on
    the host), and, as the parent's "before", the torch upper-layer descent
    (`traverse.upper_entry`, a host sync a greedy step) and the layer-0
    entry alone from its endpoints.  Device times and bounds of the fused
    walk and the layer-0 entry on the real graph, and the time a hop over
    the batch's longest chain."""
    import torch
    from repro_torch.graph import beam_plan, traverse
    from repro_torch.kernels.graph_expand import graph_expand
    gf = eng.backend
    Qb = torch.from_numpy(np.asarray(Q[:BATCH], np.float32)).to(
        gf._db[0].device)
    kp = K * RATIO_K
    ef, ef_cap, max_hops = beam_plan(kp, max(EF_SEARCH, kp))
    C = gf._db[0]
    R, M0 = gf._neigh0.shape
    M = gf._neigh_up.shape[2]
    d = Qb.shape[1]

    def timed(fn):
        return host_ms(fn, reps)

    walk = lambda: graph_expand.graph_walk(
        gf._neigh0, gf._neigh_up, gf._ok, C, Qb, gf.csr.entry, ef,
        ef_cap=ef_cap, max_hops=max_hops)
    upper = lambda: traverse.upper_entry(gf._neigh_up, gf._ok, gf._db, Qb,
                                         gf.csr.entry)
    ep, ep_d, up_hops, up_edges = upper()
    layer0 = lambda: graph_expand.expand_layer0(
        gf._neigh0, gf._ok, C, Qb, ep, ep_d, ef, ef_cap=ef_cap,
        max_hops=max_hops)
    _, _, visited, hops, edges = walk()
    # the kernel's (nq, ceil(R/32)) words, packed again from the trace
    pad = torch.zeros((visited.shape[0], -R % 32), dtype=torch.bool,
                      device=visited.device)
    bits = torch.cat([visited, pad], 1).view(visited.shape[0], -1, 32)
    words = (bits.int() << torch.arange(32, device=bits.device,
                                        dtype=torch.int32)).sum(
        -1, dtype=torch.int32)
    unpacked = lambda: np.unpackbits(
        words.cpu().numpy().view(np.uint8), axis=1,
        bitorder="little")[:, :R].astype(bool)
    if not np.array_equal(unpacked(), visited.cpu().numpy()):
        raise AssertionError("packed scan trace differs from the bool one")
    _, _, _, l0_hops, l0_edges = layer0()
    b_walk, b_walk_by = graph_expand_bound(hops - up_hops, edges - up_edges,
                                           R, M0, d, ef_cap, up_hops,
                                           up_edges, M)
    b_l0, b_l0_by = graph_expand_bound(l0_hops, l0_edges, R, M0, d, ef_cap)
    walk_dev = device_ms(walk)
    return {
        "phase": "graph_breakdown", "batch": BATCH, "reps": reps,
        "search_batch_ms": timed(lambda: eng.search_batch(
            Q[:BATCH], T[:BATCH], K, ratio_k=RATIO_K, ef_search=EF_SEARCH)),
        "filter_candidates_ms": timed(lambda: gf.candidates(
            Q[:BATCH], kp, EF_SEARCH)),
        "graph_walk_ms": timed(walk),
        "graph_walk_device_ms": walk_dev,
        "graph_walk_bound_ms": b_walk, "graph_walk_bound_by": b_walk_by,
        "graph_walk_us_per_hop": 1e3 * walk_dev / int(hops.max()),
        "trace_download_ms": timed(lambda: visited.cpu()),
        "trace_packed_download_unpack_ms": timed(unpacked),
        "before_torch_descent_ms": timed(upper),
        "expand_layer0_ms": timed(layer0),
        "expand_layer0_device_ms": device_ms(layer0),
        "expand_layer0_bound_ms": b_l0, "expand_layer0_bound_by": b_l0_by,
        "expand_layer0_us_per_hop":
            1e3 * device_ms(layer0) / max(1, int(l0_hops.max())),
        "hops_per_query_mean": float(hops.float().mean()),
        "hops_per_query_max": int(hops.max()),
        "upper_hops_per_query_mean": float(up_hops.float().mean()),
        "layer0_hops_per_query_mean": float(l0_hops.float().mean()),
        "layer0_edges_per_query_mean": float(l0_edges.float().mean()),
    }


@contextlib.contextmanager
def counted_descents(out: list):
    """Count the torch upper-layer descents (`traverse.upper_entry`)."""
    from repro_torch.graph import traverse
    inner = traverse.upper_entry

    def counted(*a, **kw):
        out.append(1)
        return inner(*a, **kw)
    traverse.upper_entry = counted
    try:
        yield
    finally:
        traverse.upper_entry = inner


def graph_path(g: dict) -> dict:
    import warnings

    import torch
    from repro_torch.data import synth
    from repro_torch.graph import GraphFilter
    from repro_torch.serving.search_engine import (HNSWGraphFilter,
                                                   SecureSearchEngine)
    ds, Q, T = g["ds"], g["Q"], g["T"]
    index, build_s = graph_index(g)
    t_wait = g["t_wait"]
    log(json.dumps({"phase": "graph_build", "n": index.size,
                    "hnsw_M": GRAPH_M,
                    "hnsw_ef_construction": GRAPH_EF_CONSTRUCTION,
                    "build_s": build_s, "waited_for_build_s": t_wait,
                    "layers": len(index.links)}))

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    eng = SecureSearchEngine(g["C_sap"], g["C_dce"],
                             backend=GraphFilter(index))      # the card
    t0 = time.perf_counter()
    eng.search_batch(Q[:BATCH], T[:BATCH], K, ratio_k=RATIO_K,
                     ef_search=EF_SEARCH)        # CSR mirror + upload
    t_warm = time.perf_counter() - t0

    reset_launches()
    walks, stats, descents = [], [], []
    t0 = time.perf_counter()
    with recorded_walks(walks), counted_descents(descents):
        ids, lat = run_batches(eng, Q, T, stats)
    t_run = time.perf_counter() - t0
    launches = kernel_launches()
    resident = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    with plain_kernels():
        ids_plain, lat_plain = run_batches(eng, Q, T)
    t_plain = time.perf_counter() - t0
    if kernel_launches() != launches:
        raise AssertionError("a kernel launched during the plain run")

    prof = profile_batches(eng, Q, T)
    log(json.dumps(dict(prof, path="graph")))
    log(json.dumps(graph_breakdown(eng, Q, T)))

    t0 = time.perf_counter()
    oracle = SecureSearchEngine(g["C_sap"], g["C_dce"],
                                backend=HNSWGraphFilter(index))
    with warnings.catch_warnings():         # the host walk is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        ids_host, _ = run_batches(oracle, Q[:ORACLE_QUERIES],
                                  T[:ORACLE_QUERIES])
    t_oracle = time.perf_counter() - t0

    hops = torch.cat([h for h, _ in walks]).cpu().numpy()
    edges = torch.cat([e for _, e in walks]).cpu().numpy()
    rec = synth.recall_at_k(ids, ds.gt, K)
    rec_plain = synth.recall_at_k(ids_plain, ds.gt, K)
    agree = float((ids == ids_plain).mean())
    nq = Q.shape[0]
    out = {
        "phase": "graph_path", "n": ds.n, "d": ds.d, "queries": nq,
        "batch": BATCH, "k": K, "k_prime": K * RATIO_K,
        "ef_search": EF_SEARCH, "hnsw_M": GRAPH_M,
        "hnsw_ef_construction": GRAPH_EF_CONSTRUCTION,
        "recall@10": rec, "recall@10_plain": rec_plain,
        "id_agreement": agree,
        "host_walk_queries": ORACLE_QUERIES,
        "host_walk_id_agreement": float(
            (ids[:ORACLE_QUERIES] == ids_host).mean()),
        "recall@10_host_walk": synth.recall_at_k(
            ids_host, ds.gt[:ORACLE_QUERIES], K),
        "qps": nq / sum(lat),
        "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "batch_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "qps_plain": nq / sum(lat_plain),
        "batch_p50_ms_plain": float(np.percentile(lat_plain, 50)) * 1e3,
        "batch_p99_ms_plain": float(np.percentile(lat_plain, 99)) * 1e3,
        "hops_per_query_mean": float(hops.mean()),
        "hops_per_query_max": int(hops.max()),
        "edges_per_query_mean": float(edges.mean()),
        "edges_per_query_max": int(edges.max()),
        "search_stats": {f: int(sum(getattr(st, f) for st in stats))
                         for f in ("filter_dist_evals", "n_hops",
                                   "n_edges_scanned", "filter_bytes_scanned",
                                   "refine_comparisons")},
        "launches": launches, "torch_descents": len(descents),
        "device_resident_bytes": resident - before,
        "device_peak_bytes": peak - before,
        "device_bytes_held_before_the_engine": before,
        "build_s": build_s,
        "wall_s": {"dataset": g["t_data"], "encrypt_vectors": g["t_enc"],
                   "hnsw_build": build_s,
                   "waited_for_build": t_wait,
                   "first_batch_with_csr_and_upload": t_warm,
                   "kernel_run": t_run, "plain_run": t_plain,
                   "host_walk_oracle": t_oracle},
    }
    log(json.dumps(out))
    if ids.shape != (nq, K) or (ids < 0).any() or (ids >= ds.n).any():
        raise AssertionError("graph path returned ids outside the database")
    if (launches["graph_expand.graph_walk"] != len(lat)
            or launches["graph_expand.expand_layer0"] != 0
            or launches["dce_comp.refine_topk"] != len(lat) or descents):
        raise AssertionError(f"graph path kernels: {launches} and "
                             f"{len(descents)} torch descents for "
                             f"{len(lat)} batches (one graph_walk and one "
                             f"refine_topk a batch, no torch descent)")
    if agree < MIN_ID_AGREEMENT or abs(rec - rec_plain) > MAX_RECALL_GAP:
        raise AssertionError(f"kernel and plain runs disagree: ids "
                             f"{agree}, recall {rec} vs {rec_plain}")
    return launches


# --------------------------------------------------------------- phase 6

RT_THREADS = 8                  # client threads of the scheduler passes
RT_WINDOW = 32                  # requests a client keeps in flight
RT_BURSTS = 10                  # insert bursts of the live-ingestion run
RT_DELETES = 1000               # rows deleted on the flat and int8 runs


def drive_clients(col, Q, T, n_threads: int = RT_THREADS,
                  window: int = RT_WINDOW):
    """`n_threads` client threads, each submitting its share of the
    queries through the collection's scheduler in windows of `window`
    requests and waiting for each window.  -> (ids (nq, K) in query
    order, the engine calls' latencies, wall seconds).  A client's
    failure is raised here."""
    import threading
    nq = Q.shape[0]
    ids = np.full((nq, K), -2, np.int64)
    calls, errors = {}, []
    share = -(-nq // n_threads)

    def client(lo, hi):
        try:
            for s in range(lo, hi, window):
                futs = [(i, col.submit(Q[i], T[i], K, ratio_k=RATIO_K,
                                       ef_search=EF_SEARCH,
                                       want_stats=True))
                        for i in range(s, min(s + window, hi))]
                for i, fut in futs:
                    row, st = fut.result(timeout=300)
                    ids[i] = row
                    calls[id(st)] = st      # held: ids stay unique
        except BaseException as exc:         # re-raised by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=client,
                                args=(t * share, min(nq, (t + 1) * share)))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads) or (ids == -2).any():
        raise AssertionError("a client thread did not finish")
    return ids, [st.latency_s for st in calls.values()], wall


def against_plain(col, Q, T, ids, what: str) -> dict:
    """The same queries through the same collection with the kernels
    swapped for their plain versions: ids must agree in >= 99.9% of
    slots, and no kernel may launch."""
    before = kernel_launches()
    with plain_kernels():
        plain, _ = run_batches(col, Q, T)
    if kernel_launches() != before:
        raise AssertionError(f"{what}: a kernel launched during the plain "
                             f"run")
    agree = float((ids == plain).mean())
    if agree < MIN_ID_AGREEMENT:
        raise AssertionError(f"{what}: kernel and plain ids agree in "
                             f"{agree} of slots")
    return {"id_agreement_plain": agree,
            "ids_equal_plain": bool((ids == plain).all())}


def deleted_returned(ids, gone) -> int:
    return int(np.isin(ids, gone).sum())


def backend_device_bytes(b) -> int:
    """Bytes of the device tensors a runtime backend holds (the refine
    array included)."""
    held = [b._C_main, b._C_all, b._C_delta, b._C_dce_dev, b._adc_c8,
            b._adc_cn, b._adc_codes_t, b._adc_ok, b._g_neigh0,
            b._g_neigh_up, b._g_ok]
    return sum(int(t.nbytes) for t in held if t is not None)


def rt_common(col, lat, wall: float, launches: dict, n_calls: int,
              audit: int) -> dict:
    """The fields every runtime_path line carries."""
    import torch
    from repro_torch.serving.runtime import jit_cache_size
    snap = col.stats()
    served = snap["n_requests"] > 0
    return {
        "rows": col.store.n_total, "rows_alive": col.store.n_alive,
        "device_resident_bytes": backend_device_bytes(col._backend),
        "device_allocated_bytes": torch.cuda.memory_allocated(),
        "engine_calls": n_calls,
        "engine_batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "engine_batch_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "launches": launches,
        "launches_per_batch": {k: v / n_calls for k, v in launches.items()
                               if v},
        "recompiles": jit_cache_size() - audit,
        "wall_s": wall,
        # sojourn exists only for requests a scheduler served; the ADC
        # and graph runs call the engine directly
        "sojourn_p50_ms": snap["p50_latency_s"] * 1e3 if served else None,
        "sojourn_p99_ms": snap["p99_latency_s"] * 1e3 if served else None,
        "telemetry": {k: snap[k] for k in (
            "qps", "n_requests", "n_batches", "n_steps", "batch_occupancy",
            "slot_occupancy", "n_inserts", "n_deletes", "n_compactions")},
    }


def delta_knn_cost(b, Q) -> dict:
    """Device time of the flat backend's two K1 calls of one batch: the
    main region and the sentinel-padded delta bucket (CUDA events; not
    counted as the path's launches)."""
    import torch
    from repro_torch.kernels.l2_topk import ops as l2_ops
    kp = K * RATIO_K
    Qd = torch.from_numpy(np.asarray(Q[:BATCH], np.float32)).to(
        b._C_main.device)
    bucket = int(b._C_delta.shape[0])
    n_main = int(b._C_main.shape[0])
    with untallied():
        delta_ms = device_ms(lambda: l2_ops.knn(
            Qd, b._C_delta, min(kp, bucket), chunk=bucket))
        main_ms = device_ms(lambda: l2_ops.knn(Qd, b._C_main, kp,
                                               chunk=min(4096, n_main)))
    return {"delta_rows": b._delta_n, "delta_bucket": bucket,
            "main_rows": n_main, "knn_delta_device_ms": delta_ms,
            "knn_main_device_ms": main_ms}


def runtime_flat(ctx: dict, scheduler: str, ref: dict | None,
                 phase2_ms: dict) -> tuple[dict, dict]:
    """(a)-(b), or (c) with `ref` the flush run's checkpoints: a keyless
    flat collection over phase 3's first 990,000 rows, client threads
    through the scheduler, then live ingestion: 10 bursts of 1,000 of the
    held-out rows (a batch after each: two K1 calls while the delta is
    non-empty), compaction to phase 3's 1M rows, and 1,000 deletes.
    -> (checkpoint ids, launches)."""
    import torch
    from repro_torch.obs import profile_kernels
    from repro_torch.serving.runtime import (CollectionManager,
                                             jit_cache_size)
    Q, T, C_sap, C_dce = ctx["Q"], ctx["T"], ctx["C_sap"], ctx["C_dce"]
    n = C_sap.shape[0]
    n0 = n - RT_BURSTS * 1000
    flush = scheduler == "flush"
    path = "flat_flush" if flush else "flat_continuous"
    t_start = time.perf_counter()
    mgr = CollectionManager()                          # device: the card
    col = mgr.create_collection(
        "t0", "sift", C_sap.shape[1], backend="flat", keyless=True,
        max_batch=BATCH, max_wait_ms=2, compact_every=1_000_000,
        scheduler=scheduler)
    t0 = time.perf_counter()
    col.load_snapshot(C_sap[:n0], C_dce[:n0])
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    col.warmup(k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
    t_warm = time.perf_counter() - t0
    audit = jit_cache_size()
    cp, lat, checks = {}, [], {}

    # (a) / (c): client threads through the scheduler
    reset_launches()
    ids, calls, wall = drive_clients(col, Q, T)
    lat += calls
    n_calls = len(calls)
    cp["clients"] = ids
    snap = col.stats()
    rec_a = {"phase": "runtime_path", "path": path, "scheduler": scheduler,
             "step": "clients", "threads": RT_THREADS,
             "window": RT_WINDOW, "queries": Q.shape[0],
             "qps_wall": Q.shape[0] / wall,
             "qps_telemetry": snap["qps"],
             "load_snapshot_s": t_load, "warmup_s": t_warm}
    direct, lat_d = run_batches(col, Q, T)       # the direct engine path
    lat += lat_d
    n_calls += Q.shape[0] // BATCH
    rec_a["id_agreement_direct"] = float((ids == direct).mean())
    if ref is not None:
        rec_a["id_agreement_flush"] = float((ids == ref["clients"]).mean())
    rec_a.update(rt_common(col, lat, time.perf_counter() - t_start,
                           kernel_launches(), n_calls, audit))
    log(json.dumps(rec_a))
    if (ids != direct).any() or (ref is not None
                                 and (ids != ref["clients"]).any()):
        raise AssertionError(f"{path}: scheduler ids differ from the "
                             f"direct engine's or the flush run's")

    if flush:
        # (f) one flush pass under the kernel profiler
        with profile_kernels() as prof:
            _, calls_f, _ = drive_clients(col, Q, T)
        lat += calls_f
        n_calls += len(calls_f)
        prof_line = {"phase": "runtime_profile", "path": path,
                     "engine_calls": len(calls_f), "kernels": {}}
        for name, s in sorted(prof.summary().items()):
            prof_line["kernels"][name] = {
                "calls": s["calls"],
                "cuda_event_ms_per_call": s["total_s"] * 1e3 / s["calls"],
                "bytes_per_call": s["total_bytes"] / s["calls"],
                "phase2_device_ms": phase2_ms.get(name)}
        log(json.dumps(prof_line))

    # (b) live ingestion
    gen_check, lat_b = [], []
    served = [0, 0.0]               # queries searched in (b), seconds
    for b in range(RT_BURSTS):
        lo = n0 + 1000 * b
        col.insert_encrypted(C_sap[lo:lo + 1000], C_dce[lo:lo + 1000])
        s = (BATCH * b) % Q.shape[0]
        k1 = kernel_launches()["l2_topk.knn"]
        t0 = time.perf_counter()
        if flush:
            out, lat_d = run_batches(col, Q[s:s + BATCH], T[s:s + BATCH])
            lat_b += lat_d
            n_calls += 1
        else:
            out, calls, _ = drive_clients(col, Q[s:s + BATCH],
                                          T[s:s + BATCH], window=4)
            lat_b += calls
            n_calls += len(calls)
        served[0] += BATCH
        served[1] += time.perf_counter() - t0
        gen_check.append(kernel_launches()["l2_topk.knn"] - k1)
        cp[f"burst{b}"] = out
    if flush and gen_check != [2] * RT_BURSTS:
        raise AssertionError(f"K1 calls a batch with a live delta: "
                             f"{gen_check} (two expected: main and delta)")
    def search():
        """All queries: direct batches (flush run) or client threads
        through the slot loop (continuous run); -> (ids, engine calls)."""
        t0 = time.perf_counter()
        if flush:
            out, calls = run_batches(col, Q, T)
            lat_b.extend(calls)
        else:
            out, calls, _ = drive_clients(col, Q, T)
            lat_b.extend(calls)
        served[0] += Q.shape[0]
        served[1] += time.perf_counter() - t0
        return out, len(calls)

    cp["bursts_done"], c = search()
    n_calls += c
    if flush:
        checks["bursts_done"] = against_plain(col, Q, T, cp["bursts_done"],
                                              f"{path} after the bursts")
        delta_cost = delta_knn_cost(col._backend, Q)
        delta_cost["batch_p50_ms_with_delta"] = float(
            np.percentile(lat_b[-c:], 50)) * 1e3
    col.compact()
    cp["compacted"], c = search()
    n_calls += c
    if flush:
        delta_cost["batch_p50_ms_compacted"] = float(
            np.percentile(lat_b[-c:], 50)) * 1e3
    phase3 = ctx["ids"]
    checks["compacted"] = {
        "id_agreement_phase3": float((cp["compacted"] == phase3).mean()),
        "ids_equal_phase3": bool((cp["compacted"] == phase3).all())}
    if checks["compacted"]["id_agreement_phase3"] < MIN_ID_AGREEMENT:
        raise AssertionError(f"{path}: compacted ids against phase 3's: "
                             f"{checks['compacted']}")
    if ref is None:
        rng = np.random.default_rng(OWNER_SEED + 11)
        seen = np.unique(cp["compacted"])
        seen = seen[seen >= 0]
        hit = rng.choice(seen, size=min(300, seen.size), replace=False)
        rest = np.setdiff1d(np.arange(n), hit)
        gone = np.concatenate([hit, rng.choice(rest, RT_DELETES - hit.size,
                                               replace=False)])
    else:
        gone = ref["gone"]
    cp["gone"] = gone
    col.delete(gone)
    cp["deleted"], c = search()
    n_calls += c
    launches = kernel_launches()
    if flush:
        checks["deleted"] = against_plain(col, Q, T, cp["deleted"],
                                          f"{path} after the deletes")
    n_back = deleted_returned(cp["deleted"], gone)
    checks["deleted"] = dict(checks.get("deleted", {}),
                             deleted_ids_returned=n_back,
                             deleted_ids_in_compacted_answers=int(
                                 np.isin(gone, cp["compacted"]).sum()))
    if ref is not None:
        for key in ("bursts_done", "compacted", "deleted",
                    *(f"burst{b}" for b in range(RT_BURSTS))):
            agree = float((cp[key] == ref[key]).mean())
            checks.setdefault("continuous_vs_flush", {})[key] = agree
            if agree < 1.0:
                raise AssertionError(f"continuous ids differ from flush at "
                                     f"{key}: {agree}")
    rec_b = {"phase": "runtime_path", "path": path,
             "scheduler": scheduler, "step": "clients+ingest",
             "bursts": RT_BURSTS, "burst_rows": 1000,
             "deletes": len(gone), "checks": checks,
             "k1_calls_per_burst_batch": gen_check,
             "deleted_ids_returned": n_back,
             "qps_ingest_searches": served[0] / served[1],
             "delta_cost": delta_cost if flush else None,
             **rt_common(col, lat + lat_b, time.perf_counter() - t_start,
                         launches, n_calls, audit)}
    log(json.dumps(rec_b))
    if n_back or rec_b["recompiles"]:
        raise AssertionError(f"{path}: {n_back} deleted ids returned, "
                             f"{rec_b['recompiles']} kernel rebuilds")
    mgr.drop_collection("t0", "sift")
    del col, mgr
    gc.collect()
    torch.cuda.empty_cache()
    return cp, launches


def runtime_adc(ctx: dict, quantization: str, gone=None) -> dict:
    """(d): a keyless ADC collection (`quantization` int8 over phase 3's
    1M rows with the flat run's deletes, or pq8 over the graph corpus),
    its queries directly in batches of 32, against its plain run."""
    import torch
    from repro_torch.serving.runtime import Collection, jit_cache_size
    Q, T, C_sap, C_dce = ctx["Q"], ctx["T"], ctx["C_sap"], ctx["C_dce"]
    path = f"adc_{quantization}"
    t_start = time.perf_counter()
    col = Collection("t0", path, C_sap.shape[1], backend="flat",
                     quantization=quantization, keyless=True,
                     max_batch=BATCH, compact_every=1_000_000)
    try:
        col.load_snapshot(C_sap, C_dce)
        t0 = time.perf_counter()
        col.warmup(k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        t_warm = time.perf_counter() - t0        # the codebook: at attach
        audit = jit_cache_size()
        if gone is not None:                     # the ok stream, in place
            col.delete(gone)
        reset_launches()
        ids, lat = run_batches(col, Q, T)
        launches = kernel_launches()
        checks = against_plain(col, Q, T, ids, path)
        n_back = deleted_returned(ids, gone) if gone is not None else 0
        kern = ("adc_topk.sq_adc_topk" if quantization == "int8"
                else "adc_topk.pq_adc_topk")
        nb = len(lat)
        rec = {"phase": "runtime_path", "path": path, "queries": Q.shape[0],
               "qps": Q.shape[0] / sum(lat),
               "warmup_with_codebook_s": t_warm,
               "deletes": 0 if gone is None else len(gone),
               "deleted_ids_returned": n_back, "checks": checks,
               **rt_common(col, lat, time.perf_counter() - t_start,
                           launches, nb, audit)}
        log(json.dumps(rec))
        if (n_back or rec["recompiles"] or launches[kern] != nb
                or launches["dce_comp.refine_topk"] != nb):
            raise AssertionError(f"{path}: {rec}")
    finally:
        col.close()
    del col
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def runtime_graph(g: dict) -> dict:
    """(e): a keyless graph collection over phase 1's corpus and HNSW
    (`load_snapshot(graph_arrays=...)`), 1% of its rows deleted (K6 walks
    past rows with ok = 0), then the 1,000 rows phase 1 held out inserted
    (host HNSW inserts, CSR rows refreshed); all queries against the
    plain torch walk."""
    import torch
    from repro_torch.serving.runtime import Collection, jit_cache_size
    Q, T, C_sap, C_dce = g["Q"], g["T"], g["C_sap"], g["C_dce"]
    index, _ = graph_index(g)
    n = C_sap.shape[0]
    t_start = time.perf_counter()
    col = Collection("t0", "graph", C_sap.shape[1], backend="graph",
                     keyless=True, max_batch=BATCH, compact_every=1_000_000,
                     hnsw_M=GRAPH_M, hnsw_ef_construction=GRAPH_EF_CONSTRUCTION)
    try:
        t0 = time.perf_counter()
        col.load_snapshot(C_sap, C_dce, graph_arrays=index.to_arrays())
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        col.warmup(k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)   # CSR mirror
        t_warm = time.perf_counter() - t0
        audit = jit_cache_size()
        gone = np.random.default_rng(OWNER_SEED + 13).choice(
            n, n // 100, replace=False)
        t0 = time.perf_counter()
        col.delete(gone)                     # ok = 0 rows, repaired rows
        t_delete = time.perf_counter() - t0
        reset_launches()
        ids_d, lat = run_batches(col, Q, T)
        launches = kernel_launches()
        checks = {"deleted": against_plain(col, Q, T, ids_d,
                                           "graph after the deletes")}
        t0 = time.perf_counter()
        col.insert_encrypted(g["extra_sap"], g["extra_dce"])  # host HNSW
        t_insert = time.perf_counter() - t0
        reset_launches()
        ids, lat_i = run_batches(col, Q, T)
        lat += lat_i
        launches = {k: v + launches[k] for k, v in kernel_launches().items()}
        checks["inserted"] = against_plain(col, Q, T, ids,
                                           "graph after the inserts")
        n_back = deleted_returned(ids_d, gone) + deleted_returned(ids, gone)
        nb = len(lat)
        rec = {"phase": "runtime_path", "path": "graph",
               "queries": Q.shape[0], "qps": 2 * Q.shape[0] / sum(lat),
               "deletes": len(gone), "inserts": g["extra_sap"].shape[0],
               "deleted_ids_returned": n_back,
               "inserted_ids_returned": int((ids >= n).sum()),
               "checks": checks,
               "host_s": {"load_snapshot": t_load, "warmup_csr": t_warm,
                          "delete": t_delete, "insert": t_insert},
               **rt_common(col, lat, time.perf_counter() - t_start,
                           launches, nb, audit)}
        log(json.dumps(rec))
        if (n_back or rec["recompiles"]
                or launches["graph_expand.graph_walk"] != nb
                or launches["dce_comp.refine_topk"] != nb):
            raise AssertionError(f"graph runtime: {rec}")
    finally:
        col.close()
    del col
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def runtime_paths(corpus: dict, graph: dict, records: list) -> dict:
    """Phase 6: the serving runtime on the card.  -> launches by path."""
    phase2_ms = {}
    for r in records:
        if r["name"] == f"l2_topk.knn[nq={BATCH},n=1000000,d=128," \
                        f"k={K * RATIO_K}]":
            phase2_ms["l2_topk.knn"] = r["ms"]
        if r["name"].startswith(f"dce_comp.refine_topk[B={BATCH},"
                                f"n={K * RATIO_K},"):
            phase2_ms["dce_comp.refine_topk"] = r["ms"]
    t0 = time.perf_counter()
    cp, on_flat = runtime_flat(corpus, "flush", None, phase2_ms)
    _, on_cont = runtime_flat(corpus, "continuous", cp, phase2_ms)
    on_int8 = runtime_adc(corpus, "int8", cp["gone"])
    on_pq8 = runtime_adc(graph, "pq8")
    on_graph = runtime_graph(graph)
    log(json.dumps({"phase": "runtime_done",
                    "wall_s": time.perf_counter() - t0}))
    return {"runtime_flat": on_flat, "runtime_flat_continuous": on_cont,
            "runtime_int8": on_int8, "runtime_pq8": on_pq8,
            "runtime_graph": on_graph}


# --------------------------------------------------------------- phase 7

API_THREADS = 8                 # client threads of the coalesced pass
API_PER_THREAD = 128            # single-query requests each submits (at
                                # most: --queries / 8 on a short run)
# the leakage harness's replay scale (BENCH_attacks.json's leak_n,
# leak_d and leak_nq), its profiles and its backend cells
LEAK_N, LEAK_D, LEAK_NQ = 2048, 32, 64
LEAK_PROFILES = ("perf", "balanced", "hardened", "oblivious-sketch")
LEAK_IVF_CELLS = (("ivf", None), ("ivf", "int8"))


def api_params():
    from repro_torch.api import SearchParams
    return SearchParams(k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)


def api_batches(svc, name: str, Q, T, wire: bool = False):
    """Every query as batch requests of 32 (coalesce=False), each through
    `SearchRequest.to_bytes` -> `from_bytes` and its result through
    `SearchResult.to_bytes` -> `from_bytes` when `wire`, as between two
    processes.  -> (ids, request seconds, request bytes, result bytes,
    seconds of each request spent packing and unpacking)."""
    from repro_torch.api import (EncryptedQuery, SearchRequest,
                                 SearchResult)
    ids, lat, wire_s, up, down = [], [], [], 0, 0
    for s in range(0, Q.shape[0], BATCH):
        req = SearchRequest(tenant="t0", collection=name,
                            query=EncryptedQuery(C_sap=Q[s:s + BATCH],
                                                 T=T[s:s + BATCH]),
                            params=api_params(), coalesce=False)
        t0 = time.perf_counter()
        if wire:
            data = req.to_bytes()
            got = SearchRequest.from_bytes(data)
            t1 = time.perf_counter()
            res = svc.submit(got)
            t2 = time.perf_counter()
            out = res.to_bytes()
            back = SearchResult.from_bytes(out)
            wire_s.append(time.perf_counter() - t2 + t1 - t0)
            up, down = up + len(data), down + len(out)
            if not (np.array_equal(back.ids, res.ids)
                    and back.stats == res.stats):
                raise AssertionError("a SearchResult changed on the wire")
            res = back
        else:
            res = svc.submit(req)
        lat.append(time.perf_counter() - t0)
        ids.append(res.ids)
    return np.concatenate(ids), lat, up, down, wire_s


def api_clients(svc, name: str, Q, T):
    """API_THREADS client threads, each submitting its share (at most
    API_PER_THREAD) of single-query requests one after another
    (coalesce=True: the collection's flush batcher shares engine calls
    between the threads), each request and result through the wire.
    -> (ids in query order, request seconds, wall seconds, request
    bytes, result bytes, seconds of each request spent packing and
    unpacking).  A client's failure, a hang included (the service's
    result timeout), is raised here."""
    import threading
    from repro_torch.api import (EncryptedQuery, SearchRequest,
                                 SearchResult)
    per = min(API_PER_THREAD, Q.shape[0] // API_THREADS)
    nq = API_THREADS * per
    ids = np.full((nq, K), -2, np.int64)
    lat, wire_s = np.zeros(nq), np.zeros(nq)
    sizes = np.zeros((nq, 2), np.int64)
    errors = []

    def client(lo, hi):
        try:
            for i in range(lo, hi):
                req = SearchRequest(tenant="t0", collection=name,
                                    query=EncryptedQuery(C_sap=Q[i:i + 1],
                                                         T=T[i:i + 1]),
                                    params=api_params())
                t0 = time.perf_counter()
                data = req.to_bytes()
                got = SearchRequest.from_bytes(data)
                t1 = time.perf_counter()
                res = svc.submit(got)
                t2 = time.perf_counter()
                out = res.to_bytes()
                ids[i] = SearchResult.from_bytes(out).ids[0]
                t3 = time.perf_counter()
                lat[i], wire_s[i] = t3 - t0, t3 - t2 + t1 - t0
                sizes[i] = len(data), len(out)
        except BaseException as exc:         # re-raised by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(t * per, (t + 1) * per))
               for t in range(API_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads) or (ids == -2).any():
        raise AssertionError("an API client thread did not finish")
    return ids, list(lat), wall, int(sizes[:, 0].sum()), \
        int(sizes[:, 1].sum()), list(wire_s)


def ms_stats(lat) -> dict:
    return {"p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def api_flat(ctx: dict, tmp: Path) -> dict:
    """(a) The three roles over phase 3's corpus: the owner rebuilt
    around phase 3's keys (`DataOwner.from_keys`), its keys exported to
    a keystore, a user from that keystore with phase 3's query seed, and
    a keyless flat collection made from phase 3's ciphertexts, answering
    batch requests and coalesced single-query requests from client
    threads.  -> launches (batch and coalesced passes)."""
    import torch
    from repro_torch.api import (DataOwnerClient, EncryptedCorpus,
                                 IndexSpec, Keystore, QueryClient,
                                 SecureAnnService)
    from repro_torch.serving.runtime import jit_cache_size
    ds, keys = ctx["ds"], ctx["keys"]
    t_start = time.perf_counter()
    spec = IndexSpec(tenant="t0", name="sift", d=ds.d, backend="flat",
                     sap_beta=keys.sap_key.beta, sap_s=keys.sap_key.s,
                     seed=OWNER_SEED, max_batch=BATCH)
    owner = DataOwnerClient(spec, keys=keys)
    owner.export_keys(Keystore(tmp / "keys"))
    t0 = time.perf_counter()
    user = QueryClient.from_keystore(tmp / "keys", "t0__sift",
                                     expect_d=ds.d, seed=17)
    query = user.encrypt_queries(ds.queries)
    t_qenc = time.perf_counter() - t0
    Q, T = query.C_sap, query.T
    if not (Q.tobytes() == ctx["Q"].tobytes()
            and T.tobytes() == ctx["T"].tobytes()):
        raise AssertionError("QueryClient(seed=17) ciphertexts differ from "
                             "phase 3's User ciphertexts")
    nq = Q.shape[0]
    with SecureAnnService() as svc:                   # device: the card
        t0 = time.perf_counter()
        svc.create_collection(spec, EncryptedCorpus(C_sap=ctx["C_sap"],
                                                    C_dce=ctx["C_dce"]))
        t_create = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc.warmup("t0", "sift", k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        t_warm = time.perf_counter() - t0
        audit = jit_cache_size()
        reset_launches()
        ids, lat, up, down, wire = api_batches(svc, "sift", Q, T, wire=True)
        on_batches = kernel_launches()
        ids_c, lat_c, wall_c, up_c, down_c, wire_c = api_clients(
            svc, "sift", Q, T)
        launches = kernel_launches()
        rebuilt = jit_cache_size() - audit
        snap = svc.stats("t0", "sift")
        resident = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    nb = len(lat)
    m = ids_c.shape[0]
    rec = {"phase": "api_path", "path": "api_flat", "n": ds.n, "d": ds.d,
           "queries": nq, "k": K, "k_prime": K * RATIO_K,
           "query_ciphertexts_equal_phase3": True,
           "batch": {"requests": nb, "queries_per_request": BATCH,
                     "qps": nq / sum(lat), **ms_stats(lat),
                     "wire_p50_ms": float(np.percentile(wire, 50)) * 1e3,
                     "request_bytes_per_query": up / nq,
                     "result_bytes_per_query": down / nq,
                     "id_agreement_phase3": float((ids == ctx["ids"]).mean()),
                     "launches": on_batches},
           "coalesced": {"threads": API_THREADS, "requests": m,
                         "qps": m / wall_c, **ms_stats(lat_c),
                         "wire_p50_ms": float(
                             np.percentile(wire_c, 50)) * 1e3,
                         "request_bytes_per_query": up_c / m,
                         "result_bytes_per_query": down_c / m,
                         "engine_calls": snap["n_batches"],
                         "batch_occupancy": snap["batch_occupancy"],
                         "sojourn_p50_ms": snap["p50_latency_s"] * 1e3,
                         "sojourn_p99_ms": snap["p99_latency_s"] * 1e3,
                         "id_agreement_batch": float(
                             (ids_c == ids[:m]).mean())},
           "launches": launches, "rebuilds_after_warmup": rebuilt,
           "device_allocated_bytes": resident,
           "host_s": {"user_encrypt_queries": t_qenc,
                      "create_collection": t_create, "warmup": t_warm},
           "wall_s": time.perf_counter() - t_start}
    log(json.dumps(rec))
    if not (ids == ctx["ids"]).all():
        raise AssertionError("api flat ids differ from phase 3's")
    if not (ids_c == ids[:m]).all():
        raise AssertionError("coalesced ids differ from the batch ids")
    if (on_batches["l2_topk.knn"] != nb
            or on_batches["dce_comp.refine_topk"] != nb or rebuilt):
        raise AssertionError(f"api flat: {on_batches} for {nb} batch "
                             f"requests (one fused scan and one fused "
                             f"refine each), {rebuilt} rebuilds")
    return launches


def api_persist(g: dict, tmp: Path, quantization: str | None) -> dict:
    """(b) Persistence over phase 1's graph corpus: a keyless collection
    (`backend="graph"` with the owner's HNSW arrays, or flat int8 with
    its codebook trained at attach) searched, saved to a `.ppcol`,
    closed, loaded into a fresh service and searched again; then one
    held-out row (query 0's plaintext, encrypted by phase 1's owner)
    inserted and found, and one answered id deleted and never returned.
    -> launches."""
    import torch
    from repro_torch.api import (EncryptedCorpus, IndexSpec,
                                 SecureAnnService)
    from repro_torch.kernels import _build
    Q, T = g["Q"], g["T"]
    graph = quantization is None
    path = "api_graph" if graph else f"api_{quantization}"
    index = graph_index(g)[0].to_arrays() if graph else None
    spec = IndexSpec(tenant="t0", name=path, d=Q.shape[1],
                     backend="graph" if graph else "flat",
                     quantization=quantization, seed=OWNER_SEED,
                     hnsw_M=GRAPH_M,
                     hnsw_ef_construction=GRAPH_EF_CONSTRUCTION,
                     max_batch=BATCH, compact_every=1_000_000)
    filt = "graph_expand.graph_walk" if graph else "adc_topk.sq_adc_topk"
    t_start = time.perf_counter()
    reset_launches()
    with SecureAnnService() as svc:
        t0 = time.perf_counter()
        svc.create_collection(spec, EncryptedCorpus(
            C_sap=g["C_sap"], C_dce=g["C_dce"], index=index))
        svc.warmup("t0", path, k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        t_create = time.perf_counter() - t0        # CSR mirror / codebook
        before = kernel_launches()
        ids, lat, *_ = api_batches(svc, path, Q, T)
        on_batches = {k: v - before[k] for k, v in kernel_launches().items()}
        t0 = time.perf_counter()
        (ppcol,) = svc.save(tmp / path)
        t_save = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    events = dict(_build.events)
    t0 = time.perf_counter()
    svc = SecureAnnService.load(tmp / path)
    t_load = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        first, *_ = api_batches(svc, path, Q[:BATCH], T[:BATCH])
        t_first = time.perf_counter() - t0        # upload, CSR / codes
        ids_l, lat_l, *_ = api_batches(svc, path, Q, T)
        builds = {k: v - events[k] for k, v in _build.events.items()}
        new = svc.insert("t0", path, g["probe_sap"], g["probe_dce"])
        ids_i, *_ = api_batches(svc, path, Q[:BATCH], T[:BATCH])
        gone = int(ids_l[1, 0])
        svc.delete("t0", path, [gone])
        ids_d, *_ = api_batches(svc, path, Q, T)
        launches = kernel_launches()
    finally:
        svc.close()
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    nb = len(lat)
    rec = {"phase": "api_path", "path": path, "n": g["C_sap"].shape[0],
           "queries": Q.shape[0],
           "backend": spec.backend, "quantization": quantization,
           "qps": Q.shape[0] / sum(lat), **ms_stats(lat),
           "qps_after_load": Q.shape[0] / sum(lat_l),
           "ppcol_bytes": ppcol.stat().st_size,
           "host_s": {"create_and_warmup": t_create, "save": t_save,
                      "load": t_load,
                      "first_batch_after_load": t_first},
           "id_agreement_after_load": float((ids_l == ids).mean()),
           "first_batch_after_load_equal": bool(
               (first == ids[:BATCH]).all()),
           "kernel_builds_after_load": builds,
           "inserted_row": int(new[0]),
           "inserted_row_found": bool(int(new[0]) in ids_i[0]),
           "deleted_id": gone,
           "deleted_id_returned": int((ids_d == gone).sum()),
           "launches_per_batch_before_save": {
               k: v / nb for k, v in on_batches.items() if v},
           "launches": launches,
           "wall_s": time.perf_counter() - t_start}
    log(json.dumps(rec))
    if not (ids_l == ids).all() or not rec["first_batch_after_load_equal"]:
        raise AssertionError(f"{path}: ids after load differ from the ids "
                             f"before the save")
    if any(builds.values()):
        raise AssertionError(f"{path}: kernel builds after load: {builds}")
    if not rec["inserted_row_found"] or rec["deleted_id_returned"]:
        raise AssertionError(f"{path}: insert / delete after load: {rec}")
    if on_batches[filt] != nb or on_batches["dce_comp.refine_topk"] != nb:
        raise AssertionError(f"{path}: {on_batches} for {nb} batches (one "
                             f"{filt} and one refine_topk each)")
    return launches


def leak_cell(profile: str, backend: str, quantization):
    """Worker process: one frontier cell of the leakage harness on the
    card.  -> ([AttackResult dicts], seconds)."""
    from repro_torch.sec import evaluate_profile
    t0 = time.perf_counter()
    res = evaluate_profile(profile, backend, quantization, n=LEAK_N,
                           d=LEAK_D, nq=LEAK_NQ, seed=0)
    return [r.to_dict() for r in res], time.perf_counter() - t0


def leak_trace_check() -> dict:
    """The graph collection the harness builds for its `perf` cell (the
    same data, keys, seed and per-row HNSW inserts), built here once:
    its scan trace (the graph walk's visited words, downloaded) with the
    kernels must be bit-equal to the trace with them swapped for their
    plain versions."""
    from repro_torch.core import dcpe, ppanns
    from repro_torch.data import synth
    from repro_torch.serving.runtime import Collection
    ds = synth.make_dataset("sift1m", n=LEAK_N, n_queries=LEAK_NQ,
                            d=LEAK_D, k_gt=K, seed=0)
    owner = ppanns.DataOwner(d=LEAK_D, sap_beta=dcpe.suggest_beta(
        ds.base, fraction=0.01), sap_s=1024.0, seed=0)
    user = ppanns.User(owner.share_keys(), seed=1)
    C_sap, C_dce = owner.encrypt_vectors(ds.base)            # the card
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    col = Collection("leak", "perf-graph", LEAK_D, backend="graph", seed=0,
                     keyless=True, security_profile="perf")
    try:
        t0 = time.perf_counter()
        col.insert_encrypted(C_sap, C_dce)          # host HNSW inserts
        t_build = time.perf_counter() - t0
        with untallied():
            before = kernel_launches()
            col.search_batch(Q, T, K)
            walks = (kernel_launches()["graph_expand.graph_walk"]
                     - before["graph_expand.graph_walk"])
            trace = np.array(col._backend.last_scan_trace, copy=True)
            before = kernel_launches()
            with plain_kernels():
                col.search_batch(Q, T, K)
            if kernel_launches() != before:
                raise AssertionError("a kernel launched during the plain "
                                     "run")
            plain = np.array(col._backend.last_scan_trace, copy=True)
    finally:
        col.close()
    return {"graph_walk_launches": walks, "rows": LEAK_N,
            "queries": LEAK_NQ, "hnsw_build_s": t_build,
            "touched": int(trace.sum()),
            "touched_plain": int(plain.sum()),
            "bit_equal": bool(trace.shape == plain.shape
                              and np.array_equal(trace, plain))}


def leakage() -> dict:
    """(c) The leakage harness on the card at BENCH_attacks.json's
    replay scale: `evaluate_profile` for every profile x (ivf, ivf+int8,
    graph) -- the four graph cells in worker processes, whose host HNSW
    builds (per-row inserts, ~half a minute each) run beside the trace
    check and the IVF cells here -- and the bars of
    tests/test_leakage.py."""
    from repro_torch.sec import evaluate_profile
    t_start = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(LEAK_PROFILES)) as pool:
        jobs = {p: pool.apply_async(leak_cell, (p, "graph", None))
                for p in LEAK_PROFILES}
        trace = leak_trace_check()
        cells = {}
        for p in LEAK_PROFILES:
            for backend, quant in LEAK_IVF_CELLS:
                t0 = time.perf_counter()
                res = evaluate_profile(p, backend, quant, n=LEAK_N, d=LEAK_D,
                                       nq=LEAK_NQ, seed=0)
                cells[(p, res[0].backend)] = (
                    [r.to_dict() for r in res], time.perf_counter() - t0)
        for p, job in jobs.items():
            cells[(p, "graph")] = job.get(timeout=600)
    succ = {f"{p}/{b}": {r["attack"]: r["success"] for r in rs}
            for (p, b), (rs, _) in cells.items()}
    rec = {"phase": "leakage", "n": LEAK_N, "d": LEAK_D, "queries": LEAK_NQ,
           "trace_check": trace, "success": succ,
           "detail": {f"{p}/{b}": {"results": rs, "seconds": s}
                      for (p, b), (rs, s) in cells.items()},
           "wall_s": time.perf_counter() - t_start}
    bars = {
        "perf ivf access pattern leaks (>= 0.2)":
            succ["perf/ivf"]["access-pattern"] >= 0.2,
        "graph perf access pattern leaks (>= 0.15)":
            succ["perf/graph"]["access-pattern"] >= 0.15,
        "hardened and oblivious-sketch ivf at chance (<= 0.05)": all(
            v <= 0.05 for p in ("hardened", "oblivious-sketch")
            for b in ("ivf", "ivf+int8") for v in succ[f"{p}/{b}"].values()),
        "graph hardened the intermediate tier (> 0.05)":
            succ["hardened/graph"]["access-pattern"] > 0.05,
        "dce sign channel at chance everywhere (<= 0.05)": all(
            s["dce-kpa-sign"] <= 0.05 for s in succ.values()),
    }
    rec["bars"] = bars
    log(json.dumps(rec))
    if not trace["bit_equal"] or trace["graph_walk_launches"] != 1:
        raise AssertionError(f"leakage graph trace: {trace}")
    if not all(bars.values()):
        raise AssertionError(f"leakage bars: {bars}")
    return rec


def api_paths(corpus: dict, graph: dict) -> dict:
    """Phase 7: the public API and the leakage harness on the card.
    -> launches by path."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_api_") as tmp:
        tmp = Path(tmp)
        on_flat = api_flat(corpus, tmp)
        on_graph = api_persist(graph, tmp, None)
        on_int8 = api_persist(graph, tmp, "int8")
    leakage()
    log(json.dumps({"phase": "api_done",
                    "wall_s": time.perf_counter() - t0}))
    return {"api_flat": on_flat, "api_graph": on_graph, "api_int8": on_int8}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="flat path rows (default: SIFT1M's 1,000,000)")
    ap.add_argument("--graph-n", type=int, default=100_000,
                    help="graph path rows (default 100,000: the host HNSW "
                         "build takes minutes)")
    ap.add_argument("--queries", type=int, default=1024)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # phase 1 -------------------------------------------------------
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib.name}")
    for line in Path(str(lib) + ".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())

    # the pool's exit terminates the build worker, also on a failure
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        graph = graph_setup(args.graph_n, args.queries, pool)

        # phase 2 ---------------------------------------------------
        gen = torch.Generator(device="cuda").manual_seed(0)
        records = [check_knn(32, 1_000_000, 128, K * RATIO_K, gen),
                   check_knn(32, 2 ** 18, 960, K * RATIO_K, gen),
                   check_knn(32, 50, 128, K * RATIO_K, gen),
                   check_refine(32, 80, 128, K, gen, "flat"),
                   check_refine(32, 160, 128, K, gen, "adc_int8"),
                   check_refine(32, 320, 128, K, gen, "adc_pq8"),
                   check_l2(32, 4096, 128, gen),
                   check_l2(32, 4096, 960, gen),
                   check_z(32, 80, 128, gen), check_z(32, 80, 960, gen),
                   check_z(32, 160, 128, gen), check_z(32, 320, 128, gen),
                   check_z(1, 512, 128, gen, single=True),
                   check_graph_walk(2 ** 17, 16, 8, 8, 128, gen),
                   check_graph_walk(2 ** 20, 32, 16, 8, 128, gen),
                   check_graph_walk(2 ** 17, 32, 16, 8, 960, gen),
                   check_graph_walk(2 ** 21, 16, 8, 8, 128, gen),
                   check_graph_walk(2 ** 17, 16, 8, 8, 128, gen, ef=1600,
                                    ef_cap=2048, max_hops=8192),
                   check_graph_expand(2 ** 17, 16, 128, gen),
                   check_graph_expand(2 ** 20, 32, 128, gen),
                   check_graph_expand(2 ** 17, 32, 960, gen),
                   check_sq_adc(32, 1_000_000, 128, 160, gen),
                   check_sq_adc(32, 2 ** 18, 960, 160, gen),
                   check_sq_adc(32, 100, 128, 30, gen, n_valid=12),
                   check_pq_adc(32, 16, 1_000_000, 320, gen),
                   check_pq_adc(32, 8, 2 ** 18, 320, gen),
                   check_knn(32, 1_000_000, 128, 1600, gen,
                             home="flat_k1600", exact=True),
                   check_sq_adc(32, 1_000_000, 128, 1600, gen,
                                home="adc_int8_k1600"),
                   check_pq_adc(32, 16, 1_000_000, 1600, gen,
                                home="adc_pq8_k1600")]
        for r in records:
            log(json.dumps(dict(r, card=card)))
        gc.collect()
        torch.cuda.empty_cache()

        # phase 3 ---------------------------------------------------
        small_reference_check()
        flat, flat_k1600, corpus = main_path(args.n, args.queries)
        gc.collect()                    # the flat engine is gone: free
        torch.cuda.empty_cache()        # its 4.9 GB before the ADC paths

        # phase 4 ---------------------------------------------------
        on_adc = {"flat_k1600": flat_k1600}
        for path, quant, backend in (("adc_int8", "int8", "flat"),
                                     ("adc_pq8", "pq8", "flat"),
                                     ("ivf_int8", "int8", "ivf")):
            on_adc[path], k1600 = adc_path(corpus, quant, backend)
            if k1600 is not None:
                on_adc[f"{path}_k1600"] = k1600
            gc.collect()
            torch.cuda.empty_cache()

        # phase 6 ---------------------------------------------------
        on_runtime = runtime_paths(corpus, graph, records)

        # phase 7 ---------------------------------------------------
        on_api = api_paths(corpus, graph)
        del corpus
        gc.collect()
        torch.cuda.empty_cache()

        # phase 5 ---------------------------------------------------
        on_graph = graph_path(graph)

    paths = {"flat": flat, "graph": on_graph, **on_adc, **on_runtime,
             **on_api}
    # launches: on the path the kernel was ported for (or the record's
    # own, where its shape is another path's); launches_by_path: on each
    home = {"l2_topk.knn": "flat", "l2_topk.pairwise_sq_dists": "flat",
            "dce_comp.refine_topk": "flat",
            "dce_comp.batched_z_matrix": "flat",
            "graph_expand.graph_walk": "graph",
            "graph_expand.expand_layer0": "graph",
            "adc_topk.sq_adc_topk": "adc_int8",
            "adc_topk.pq_adc_topk": "adc_pq8"}
    for r in records:
        kern = r["name"].split("[")[0]
        kern = {"dce_comp.z_matrix": "dce_comp.batched_z_matrix"}.get(
            kern, kern)                  # z_matrix is the B = 1 kernel
        path = r.pop("home", home[kern])
        r["launches"] = paths[path][kern]
        r["launches_on"] = path
        r["launches_by_path"] = {p: c[kern] for p, c in paths.items()}
    log(json.dumps({"phase": "done",
                    "wall_s": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
