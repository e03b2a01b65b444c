"""Where the benchmark finds the parts of a cell, by name.

`BENCHMARK.json` at the root of the checkout names the cells, their
configurations, traffic mixes and metrics.  Each part is a file of its
own under this folder, found by its name:

  configs/<config>.json      the deployment: sizes, precision, engine
  traffic/<traffic>.json     the mix: batch, k, the query pool, the loop
  limits/<cell>.json         the limit of each number `correct` compares
  metrics/<metric>.py        the reader of one metric: `read(ctx)`
  work/<model>.py            the operations and bytes of one layer's work
  filters/<filter>.py        the reference's filter of one configuration

So a later cell, mix or metric is added with files and entries, and no
file here is edited for it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "ROOT", "benchmark", "workload", "config", "traffic",
           "limits", "part", "metrics_of"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_modules: dict[Path, object] = {}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    """The cell `name` of BENCHMARK.json; KeyError if there is none."""
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    for c in benchmark()["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return _json(HERE / "limits" / f"{cell}.json")


def part(kind: str, name: str):
    """The module `<kind>/<name>.py` of this folder, loaded by its path
    (a metric's name may hold dots) and kept for the process."""
    path = HERE / kind / f"{name}.py"
    mod = _modules.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"bench_h100_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return mod


def metrics_of(cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones without
    a trace, the per-layer ones with it; a metric with a `workloads`
    list only in the cells it names."""
    group = benchmark()["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell in m["workloads"]]
