#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py            # SIFT1M scale: n = 1,000,000, d = 128

Phases, each of which fails the run (non-zero exit, no final line):

1. Device and build: the card's name and power limit, the torch and
   CUDA versions, and the build of the CUDA kernels from
   `src/repro_torch/csrc/` (with nvcc's register and spill report).
2. Kernels against their plain PyTorch versions on the card, at the
   shapes the main path gives them, with times (CUDA events), bounds
   and a library yardstick.  Tolerances, all because the hand kernel and
   cuBLAS sum in different orders in true fp32:
     l2 tiles: |kernel - plain| <= 1e-5 * (||q||^2 + ||x||^2);
     Z tiles:  |kernel - plain| <= 1e-5 * max|Z|, and equal signs
               wherever |Z_plain| > 1e-5 * max|Z|.
3. The main path: a synthetic SIFT-width corpus (clustered Gaussians)
   encrypted on the card by `DataOwner.encrypt_vectors`, queries
   encrypted by `User`, and `SecureSearchEngine(backend="flat")` on the
   card answering them in batches of 32 (k = 10, k' = 80), once through
   the kernels and once with both kernels swapped for their plain
   versions.  Final ids must agree in >= 99.9% of slots and recall@10
   within 0.005 (ulp-level near-ties at the k' boundary may flip).  A
   small database is also searched on the card and on the host (plain
   versions) from the numpy encryption: the ids must be equal.

The second-to-last line is the kernels' JSON record, the last line the
device record.  Without a CUDA device the script exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

K = 10
RATIO_K = 8
BATCH = 32
L2_RTOL = 1e-5
Z_RTOL = 1e-5
MIN_ID_AGREEMENT = 0.999
MAX_RECALL_GAP = 0.005


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_FP32_FLOPS
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


@contextlib.contextmanager
def plain_kernels():
    """Test-only switch: route the main path's two kernel entry points to
    their plain PyTorch versions (cuBLAS products), for the comparison
    run.  The port itself has no such switch."""
    from repro_torch.kernels.dce_comp import dce_comp, ops as dce_ops
    from repro_torch.kernels.l2_topk import l2_topk, ops as l2_ops
    saved = (l2_ops.pairwise_sq_dists, dce_ops.batched_z_matrix)
    l2_ops.pairwise_sq_dists = l2_topk.plain_pairwise_sq_dists
    dce_ops.batched_z_matrix = dce_comp.plain_batched_z_matrix
    try:
        yield
    finally:
        l2_ops.pairwise_sq_dists, dce_ops.batched_z_matrix = saved


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
        "max_rel_err": float(err.max()) / zmax,
        "ms": device_ms(lambda: kern(C, T)),
        "plain_ms": device_ms(lambda: plain(C, T)),
        "library_ms": device_ms(
            lambda: torch.baddbmm(torch.bmm(L1, R3), L2, R4,
                                  beta=1.0, alpha=-1.0)),
        "library_call": "torch.baddbmm(torch.bmm(L1, R3), L2, R4, alpha=-1)"
                        " on pre-scaled L1, L2",
        "bound_ms": b_ms, "bound_by": b_by,
    }


# --------------------------------------------------------------- phase 3

def run_batches(eng, Q, T):
    ids, lat = [], []
    for s in range(0, Q.shape[0], BATCH):
        t0 = time.perf_counter()
        out, _ = eng.search_batch(Q[s:s + BATCH], T[s:s + BATCH], K,
                                  ratio_k=RATIO_K)
        lat.append(time.perf_counter() - t0)      # ids are on the host
        ids.append(out)
    return np.concatenate(ids), lat


def profile_batches(eng, Q, T, n_batches: int = 2) -> dict:
    """Device time by kernel over a short window of main-path batches
    (torch.profiler), and the device's busy share of that window.  The
    profiler's own host cost lengthens the window, so the idle share is
    an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(0, n_batches * BATCH, BATCH):
            eng.search_batch(Q[s:s + BATCH], T[s:s + BATCH], K,
                             ratio_k=RATIO_K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            kernels.append((dev_us / 1e3 / n_batches, ev.count // n_batches,
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
    """The card's engine against the host's plain versions on a small
    database encrypted by the numpy path: ids must be equal."""
    from repro_torch.core import dcpe, ppanns
    from repro_torch.data import synth
    from repro_torch.serving.search_engine import SecureSearchEngine
    ds = synth.make_dataset("sift1m", n=3000, n_queries=32, k_gt=K, seed=5)
    owner = ppanns.DataOwner(d=ds.d, sap_beta=dcpe.suggest_beta(
        ds.base, 0.03), seed=5)
    db = owner.encrypt_database(ds.base, build_index=False)
    user = ppanns.User(owner.share_keys())
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    got, _ = SecureSearchEngine(db.C_sap, db.C_dce).search_batch(
        Q, T, K, ratio_k=RATIO_K)
    want, _ = SecureSearchEngine(db.C_sap, db.C_dce, device="cpu")\
        .search_batch(Q, T, K, ratio_k=RATIO_K)
    agree = float((got == want).mean())
    log(json.dumps({"phase": "small_reference", "n": ds.n,
                    "queries": Q.shape[0], "id_agreement_card_vs_host":
                    agree, "recall@10": synth.recall_at_k(got, ds.gt, K)}))
    if agree < MIN_ID_AGREEMENT:
        raise AssertionError(f"card and host ids agree in only {agree}")


def main_path(n: int, n_queries: int) -> dict:
    import torch
    from repro_torch.core import dcpe, ppanns
    from repro_torch.data import synth
    from repro_torch.kernels.dce_comp import dce_comp
    from repro_torch.kernels.l2_topk import l2_topk
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
    del C_sap, C_dce
    t0 = time.perf_counter()
    eng.search_batch(Q[:BATCH], T[:BATCH], K, ratio_k=RATIO_K)   # upload
    t_warm = time.perf_counter() - t0

    l2_topk.launches = 0
    dce_comp.launches = 0
    ids, lat = run_batches(eng, Q, T)
    launches = {"l2_topk": l2_topk.launches, "dce_comp": dce_comp.launches}
    resident = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()

    with plain_kernels():
        ids_plain, lat_plain = run_batches(eng, Q, T)
    if (l2_topk.launches, dce_comp.launches) != tuple(launches.values()):
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
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if agree < MIN_ID_AGREEMENT or abs(rec - rec_plain) > MAX_RECALL_GAP:
        raise AssertionError(f"kernel and plain runs disagree: ids "
                             f"{agree}, recall {rec} vs {rec_plain}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database rows (default: SIFT1M's 1,000,000)")
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

    # phase 2 -------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = [check_l2(32, 4096, 128, gen), check_l2(32, 4096, 960, gen),
               check_z(32, 80, 128, gen), check_z(32, 80, 960, gen),
               check_z(1, 512, 128, gen, single=True)]
    for r in records:
        log(json.dumps(dict(r, card=card)))

    # phase 3 -------------------------------------------------------
    small_reference_check()
    launches = main_path(args.n, args.queries)

    for r in records:
        r["launches"] = launches["l2_topk" if r["name"].startswith("l2")
                                 else "dce_comp"]
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
