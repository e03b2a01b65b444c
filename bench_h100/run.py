"""Run one cell of the benchmark of the PyTorch/CUDA port on this
machine's card, and print its result as the last line of standard
output.

    python3 bench_h100/run.py --workload sift1m-flat.b1024-k10 \
        --seed 12345 --seconds 20 --trace 0

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics (`BENCHMARK.json`).  The run needs a CUDA card; without one, or
without the program's package (`src/repro_torch`) beside this folder,
it exits with a non-zero code and prints no result.  So it does if the
process has loaded JAX or the JAX package once the window has closed.
Every build cache stays in the checkout (`.bench_cache/`, and the
program's own `src/repro_torch/_build/`).
"""

import time

T_START = time.perf_counter()           # set-up is timed from here

import argparse                          # noqa: E402
import importlib.util                    # noqa: E402
import json                              # noqa: E402
import os                                # noqa: E402
import sys                               # noqa: E402
from pathlib import Path                 # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
HOST_THREADS = "4"

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = HOST_THREADS
_CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "cuda")
os.environ["USE_FLAX"] = "0"


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str, code: int) -> int:
    print(f"bench_h100: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = _args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if importlib.util.find_spec("repro_torch") is None:
        return _fail(f"the program's package is not under {ROOT / 'src'}", 4)
    import torch
    from bench_h100 import harness, spec

    torch.set_num_threads(int(HOST_THREADS))
    chips = int(spec.workload(args.workload)["chips"])
    if not torch.cuda.is_available():
        return _fail("no CUDA device", 3)
    if torch.cuda.device_count() < chips:
        return _fail(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} found", 3)
    cell = harness.Cell.load(args.workload, bool(args.trace))
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    loaded = sorted({m.partition(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        return _fail(f"JAX or the JAX package was loaded: {loaded}", 5)
    print(f"compared {json.dumps(out.pop('explain'))}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
