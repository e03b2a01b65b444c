#!/usr/bin/env python3
"""The fused scans' block plans timed on the card: K1 (`l2_topk.knn`), K4
(`adc_topk.sq_adc_topk`) and K5 (`adc_topk.pq_adc_topk`), each called
through its C entry with one (chunk_rows, G) after another.

For each shape it prints one JSON line a plan (device ms of the call,
scan and merge, the median of --reps behind a spin kernel; the plan's
waves and tiles a chunk) and one `fit` line: the least-squares fit of

    ms = t_tile * waves * (tiles a chunk + c) + t0

over the plans, whose c is the chunk's fixed cost that
`common.block_plan` takes (`_CHUNK_COST` of each wrapper), with the
plan the rule picks at the fitted c and at the wrapper's c, the fastest
plan timed and the plan of the rule the port had before, one block per
SM over ceil(SMs / groups) chunks ("old").  Every plan's ids and
distances must equal the first plan's, bit for bit.  K4 runs the route
its wrapper takes at the shape (`adc_topk._sq_layout`), with that route's
residency and chunk cost.

    python3 scripts/scan_plans.py                # every shape
    python3 scripts/scan_plans.py --only k1_b1024_k80 --reps 5

Needs a CUDA card; imports no JAX.  Writes its lines to standard output
and to --out (default results/scan_plans.jsonl).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.adc_topk import adc_topk  # noqa: E402
from repro_torch.kernels.common import block_plan  # noqa: E402
from repro_torch.kernels.l2_topk import l2_topk  # noqa: E402

# (name, kernel, nq, n, width (d, or m for K5), kp)
SHAPES = [
    ("k1_b1024_k80", "k1", 1024, 1_000_000, 128, 80),
    ("k1_b1024_k800", "k1", 1024, 1_000_000, 128, 800),
    ("k4_b1024_k160", "k4", 1024, 1_000_000, 128, 160),
    ("k5_b1024_k320", "k5", 1024, 1_000_000, 16, 320),
    ("k1_b32_k80", "k1", 32, 1_000_000, 128, 80),
    ("k4_b32_k160", "k4", 32, 1_000_000, 128, 160),
    ("k5_b32_k320", "k5", 32, 1_000_000, 16, 320),
    ("k1_b1024_2e24_k128", "k1", 1024, 2 ** 24, 128, 128),
]
# The G tried at a batch of 1024 besides the rules' own (each made the
# least G of its chunk length).
SWEEP = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 28, 33, 37, 41, 49, 66,
         99, 132, 264)
TILE = {"k1": l2_topk._ROWS, "k4": adc_topk._TILE["sq"],
        "k5": adc_topk._TILE["pq"]}
COST = {"k1": l2_topk._CHUNK_COST, "k5": adc_topk._CHUNK_COST["pq"]}


def device_ms(fn, reps: int) -> float:
    """Median device time of a call behind a spin kernel (so the host has
    queued the whole call before the card reaches it), in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(kernel: str, nq: int, n: int, width: int, gen):
    dev = torch.device("cuda")
    if kernel == "k1":
        return (1024.0 * torch.randn((nq, width), generator=gen, device=dev),
                1024.0 * torch.randn((n, width), generator=gen, device=dev))
    ok = torch.ones(n, dtype=torch.uint8, device=dev)
    if kernel == "k4":
        q8 = torch.randint(-127, 128, (nq, width), generator=gen,
                           device=dev, dtype=torch.int8)
        c8 = torch.randint(-127, 128, (n, width), generator=gen, device=dev,
                           dtype=torch.int8)
        cn = (c8.int() ** 2).sum(1, dtype=torch.int32)
        return q8, c8, cn, ok
    lut = torch.rand((nq, width, 256), generator=gen, device=dev)
    codes = torch.randint(0, 256, (width, n), generator=gen, device=dev,
                          dtype=torch.uint8)
    return lut, codes, ok


def caller(kernel: str, args, nq: int, width: int, kp: int, qb: int):
    """call(chunk_rows, G) -> (dists, ids) through the kernel's C entry."""
    dev = args[0].device

    def call(chunk_rows, G):
        out_i = torch.empty((nq, kp), dtype=torch.int64, device=dev)
        if kernel == "k1":
            out_d = torch.empty((nq, kp), dtype=torch.float32, device=dev)
            l2_topk._launch(*args, out_d, out_i, None, None, kp, chunk_rows,
                            G, 0)
        elif kernel == "k4":
            out_d = torch.empty((nq, kp), dtype=torch.int32, device=dev)
            adc_topk._launch_sq(*args, out_d, out_i, None, None, kp,
                                chunk_rows, G)
        else:
            out_d = torch.empty((nq, kp), dtype=torch.float32, device=dev)
            adc_topk._launch_pq(*args, out_d, out_i, None, None, kp, qb,
                                chunk_rows, G)
        return out_d, out_i
    return call


def residency(kernel: str, kp: int, width: int, qb: int, route) -> int:
    if kernel == "k1":
        return _build.function("repro_l2_knn_blocks_per_sm",
                               [_build.INT] * 4)(kp, 0, 0, 0)
    return _build.function("repro_adc_blocks_per_sm", [_build.INT] * 8)(
        int(kernel == "k5"), qb, kp, width, 0, int(route.qreg),
        route.stages, 0)


# Shapes that run one kernel variant, fitted together as well: one c and
# tile time, a t0 a shape (K1's constant is this fit).
JOINT = {"k1": ("k1_b1024_k80", "k1_b1024_2e24_k128")}


def fit(rows):
    """Least squares of ms = a * waves * tiles + b * waves + t0 (a t0 for
    each shape among the rows) -> (c = b / a, a, the t0s)."""
    shapes = sorted({r["shape"] for r in rows})
    A = np.array([[r["waves"] * r["tiles_a_chunk"], r["waves"]]
                  + [float(r["shape"] == s) for s in shapes] for r in rows])
    y = np.array([r["ms"] for r in rows])
    (a, b, *t0), *_ = np.linalg.lstsq(A, y, rcond=None)
    return b / a, a, t0


def run_shape(name, kernel, nq, n, width, kp, reps, out):
    gen = torch.Generator(device="cuda").manual_seed(nq + n + kp)
    args = inputs(kernel, nq, n, width, gen)
    if kernel == "k1":
        qb = _build.function("repro_l2_knn_queries_per_block",
                             [_build.INT])(kp)
    elif kernel == "k4":
        qb = adc_topk.sq_queries_per_block(kp)
    else:
        qb = adc_topk._layout("pq", width, nq, n, kp, args[0].device)[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    route, cost = adc_topk.SqRoute(False, False, 0), COST.get(kernel)
    if kernel == "k4":
        route = adc_topk._sq_layout(width, nq, n, kp, args[0].device)[2]
        cost = adc_topk._CHUNK_COST["sq_tma" if route.tma else "sq"]
    res = residency(kernel, kp, width, qb, route)
    slots = sms * res
    groups = -(-nq // qb)
    tile = TILE[kernel]
    tiles = -(-n // tile)
    call = caller(kernel, args, nq, width, kp, qb)

    def canon(G):
        per = -(-tiles // min(G, tiles))
        return per, -(-tiles // per)

    old_G = min(tiles, max(1, -(-sms // groups)))
    named = {"old": canon(old_G),
             "rule": canon(block_plan(groups, n, tile, slots, cost).G)}
    plans = {canon(G) for G in (SWEEP if nq > 32 else ())}
    plans |= set(named.values())
    rows, first = [], None
    for per, G in sorted(plans, key=lambda p: p[1]):
        got = call(per * tile, G)
        torch.cuda.synchronize()
        if first is None:
            first = got
        equal = all(torch.equal(a, b) for a, b in zip(got, first))
        waves = -(-groups * G // slots)
        row = {"shape": name, "G": G, "chunk_rows": per * tile,
               "tiles_a_chunk": per, "waves": waves, "blocks": groups * G,
               "ms": device_ms(lambda: call(per * tile, G), reps),
               "equal_to_first": equal,
               "as": [k for k, v in named.items() if v == (per, G)]}
        rows.append(row)
        out(row)
        assert equal, row
    wrapper = {"k1": l2_topk.knn, "k4": adc_topk.sq_adc_topk,
               "k5": adc_topk.pq_adc_topk}[kernel]
    got = wrapper(*args, kp)
    assert all(torch.equal(a, b) for a, b in zip(got, first)), name
    line = {"fit": name, "kernel": kernel, "nq": nq, "n": n, "width": width,
            "kp": kp, "queries_a_block": qb, "groups": groups,
            "tiles": tiles, "blocks_per_sm": res, "slots": slots,
            "route": route._asdict() if kernel == "k4" else None,
            "wrapper_ms": device_ms(lambda: wrapper(*args, kp), reps),
            "wrapper_equal": True}
    fastest = min(rows, key=lambda r: r["ms"])
    line["fastest"] = {"G": fastest["G"], "ms": fastest["ms"]}
    for k, (per, G) in named.items():
        line[k] = {"G": G, "ms": next(r["ms"] for r in rows
                                      if r["G"] == G)}
    if len(rows) >= 4:
        c, a, (t0,) = fit(rows)
        line.update(c=c, t_tile_us=1e3 * a, t0_ms=t0,
                    rule_at_fitted_c=block_plan(groups, n, tile, slots,
                                                max(c, 0.0)).G)
    out(line)
    del args
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", default="")
    p.add_argument("--reps", type=int, default=9)
    p.add_argument("--out", default=str(ROOT / "results" /
                                        "scan_plans.jsonl"))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_plans: needs a CUDA card", file=sys.stderr)
        return 3
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    with open(a.out, "a") as f:
        def out(obj):
            line = json.dumps(obj)
            print(line, flush=True)
            f.write(line + "\n")
        out({"card": card.strip().splitlines()[0] if card else None,
             "torch": torch.__version__})
        timed = {}
        for shape in SHAPES:
            if a.only and a.only not in shape[0]:
                continue
            timed[shape[0]] = run_shape(*shape, a.reps, out)
        for kernel, names in JOINT.items():
            if all(name in timed for name in names):
                c, t, _ = fit([r for name in names for r in timed[name]])
                out({"joint_fit": kernel, "shapes": names, "c": c,
                     "t_tile_us": 1e3 * t})
    return 0


if __name__ == "__main__":
    sys.exit(main())
