"""BENCHMARK.json against the benchmark's contract, and every part of
every cell found by its name."""

import json
import re

import pytest

from bench_h100 import compare, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

B = spec.benchmark()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(B) == KEYS
    assert B["command"] == ["python3", "bench_h100/run.py"]
    assert 1 <= len(B["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in B["paths"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_metrics_rules():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cell_parts_found_by_name(cell):
    w = spec.workload(cell)
    cfg = spec.config(w["config"])
    assert cfg["name"] == w["config"]
    mix = spec.traffic(w["traffic"])
    assert mix["name"] == w["traffic"] and mix["pool"] % mix["batch"] == 0
    limits = spec.limits(cell)
    assert "missing_share" in limits and set(limits) <= set(compare.NUMBERS)
    for layer in cfg["layers"].values():
        assert callable(spec.part("work", layer["work"]).count)
    assert callable(spec.part("filters", cfg["filter"]).Filter)
    for trace in (False, True):
        metrics = spec.metrics_of(cell, trace)
        assert metrics
        for m in metrics:
            assert callable(spec.part("metrics", m["name"]).read)
    reported = {m["name"] for m in spec.metrics_of(cell, False)}
    assert "setup_s" in reported and len(reported) >= 2


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    for c in B["configs"]:
        assert c["file"].startswith(B["paths"][0] + "/")
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
    assert len({c["source"] for c in B["configs"]}) == len(B["configs"])


def test_files_under_paths_are_named_from_name_characters():
    for path in (spec.ROOT / B["paths"][0]).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert all(NAME.match(part) for part in rel.split("/")), rel
