"""Run one cell several times, one process after another, and report each
metric's median and spread: the distance between the first and third
quartiles (`statistics.quantiles(values, n=4)`) as a share of the
median.  The bounds of BENCHMARK.json are set from these spreads.

    python3 bench_h100/spread.py --workload sift1m-flat.b1024-k10 \
        --seeds 1 2 3 4 5 6 --sets 2 --seconds 20 --out chiprun_out/spread

Each set runs every seed once, in order; the sets use the same seeds.
`--warm SEED` first makes one run whose set-up builds the kernels, kept
out of the sets.  Each run's standard output and error are written under
--out; one JSON line a run and one summary line a set go to standard
output.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_run(args, seed: int, tag: str) -> dict | None:
    cmd = [sys.executable, str(ROOT / "bench_h100" / "run.py"),
           "--workload", args.workload, "--seed", str(seed),
           "--seconds", str(args.seconds), "--trace", str(args.trace)]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=args.timeout)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stem = f"{args.workload}.t{args.trace}.{tag}.{seed}"
    (out / f"{stem}.out").write_text(res.stdout)
    (out / f"{stem}.err").write_text(res.stderr)
    lines = res.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if res.returncode == 0 else None
    except (IndexError, json.JSONDecodeError):
        result = None
    print(json.dumps({"tag": tag, "seed": seed, "rc": res.returncode,
                      "result": result}), flush=True)
    if result is None:
        print(res.stderr[-3000:], file=sys.stderr, flush=True)
    return result


def spread(values: list[float]) -> dict:
    med = statistics.median(values)
    if len(values) < 2:
        return {"median": med, "spread": None}
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"median": med, "spread": (q3 - q1) / abs(med) if med else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float, default=20)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--warm", type=int, default=None)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("--out", default="chiprun_out/spread")
    args = p.parse_args(argv)
    if args.warm is not None:
        one_run(args, args.warm, "warm")
    for s in range(args.sets):
        results = [one_run(args, seed, f"set{s + 1}") for seed in args.seeds]
        ok = [r for r in results if r is not None]
        names = sorted({m for r in ok for m in r["metrics"]})
        summary = {m: spread([r["metrics"][m]["value"] for r in ok
                              if m in r["metrics"]]) for m in names}
        print(json.dumps({"set": s + 1, "runs": len(results),
                          "results": len(ok),
                          "correct": sum(bool(r["correct"]) for r in ok),
                          "spread": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
