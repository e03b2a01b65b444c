"""The control of a cell's comparison: the reference put in the program's
place, one precision below the configuration's (`reference`, mode
"control"), judged by the comparison that decides `correct`.  It must
come out not correct.

    python3 bench_h100/control.py --workload sift1m-flat.b1024-k10 \
        --seeds 11 12 13

For each seed it makes the cell's inputs at the cell's size, answers the
whole query pool with the reference and with the control, and prints one
JSON line: the numbers compared, each beside its limit, and whether the
control would pass.  The program is not run.  The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(cell, seed: int, device) -> dict:
    """The numbers the control reads against the reference for one
    seed, at the cell's sizes."""
    import numpy as np
    import torch
    from bench_h100 import compare, datagen, reference

    sd = datagen.seeds(seed)
    k = int(cell.traffic["k"])
    P, Q = (x.cpu().numpy() for x in datagen.mixture(
        cell.cfg, int(cell.traffic["pool"]), sd["data"], torch.device(device)))
    want, cand = reference.answers(cell.cfg, k, P, Q, sd, device)
    got, _ = reference.answers(cell.cfg, k, P, Q, sd, device, mode="control")
    values = compare.measure(got, np.arange(Q.shape[0]), want, cand)
    checks = compare.judge(values, cell.limits)
    return {"seed": seed, "values": values, "checks": checks,
            "passes": all(c["value"] <= c["limit"] for c in checks.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    from bench_h100 import harness

    cell = harness.Cell.load(args.workload, False)
    for seed in args.seeds:
        t = time.perf_counter()
        out = control(cell, seed, args.device)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
