"""Dry run of every (arch x shape) cell on the `meta` device, the
counterpart of `repro.launch.dryrun` (which lowers and compiles each cell
for a 256- or 512-chip TPU mesh).

torch has no HLO and no compiler memory analysis, so a cell's record is
made from what the port has:

  * argument / output bytes per device: the metas (`param_metas`,
    `batch_metas`, `cache_metas`, the train state's) resolved to shard
    shapes by the port's specs (`param_pspecs`, `train_state_pspecs`
    with ZeRO-1 where TRAIN_SETTINGS says so) over the mesh.  Counted as
    the port holds the arguments: the train state's step and the cache's
    write position are host ints here (the reference's are int32 device
    scalars, 4 bytes each);
  * on `1card_h100` only, a trace of the step itself on `meta` tensors
    (`StepTrace`): the `Model` on meta with `seed=None`, the step as it
    runs on the card, the live device bytes at each op.  `peak_bytes` is
    the most live at once, arguments included; `temp_bytes` is the peak
    less the arguments.  On the production meshes these are null: the
    port runs no sharded LM step;
  * `cost.flops`: the trace's FLOPs by FlopCounterMode's formulas: every
    layer, every microbatch and remat's second forward (XLA's count sees
    a loop body once).  The hand-written kernels (K1, K2 of the scan
    cells) are opaque to it;
  * `collectives`: `roofline.exec_collectives`, marked analytic (there
    is no partitioned HLO to parse); 0 on one card;
  * `fits_one_card`: peak_bytes <= roofline.H100_MEMORY_BYTES.

The `ppanns-scan` cells trace the secure-scan step (`serving.
secure_scan`, K1 and K2 through their meta branches) over CARD_SHARDS
logical shards of the one card, with the cell's operand dtype: the
bf16 cells' four operands are bfloat16, as the reference's specs make
them, and K1 and K2 read their rows in place.

CLI:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch A --shape S --mesh 1card_h100
  python -m repro_torch.launch.dryrun --all             # every runnable cell
  python -m repro_torch.launch.dryrun --all --both-meshes --mesh 1card_h100
  (--out DIR changes the results directory, default results/dryrun_torch;
  --jobs N runs N cells at once)

Logical devices come from `launch.mesh.force_device_count` on the host:
nothing reads or sets an environment variable, and nothing touches a
card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, get_config
from ..models import Model
from ..models.config import SHAPES, ModelConfig, ShapeConfig
from ..models.model import batch_metas, cache_metas, n_active_params, n_params
from ..sharding.rules import (LONG_DECODE_RULES, PURE_DP_TRAIN_RULES,
                              SERVE_RULES, TRAIN_RULES, param_pspecs)
from ..training import (OptConfig, abstract_train_state, build_train_step,
                        init_train_state, train_state_pspecs)
from . import roofline
from .mesh import force_device_count, make_mesh

__all__ = ["TRAIN_SETTINGS", "DEFAULT_TRAIN", "PPANNS_CELLS", "MESH_NAMES",
           "CARD_SHARDS", "model_flops", "rules_for", "runnable",
           "all_cells", "StepTrace", "cell_record", "run_cell", "main"]

RESULTS_DIR = "results/dryrun_torch"
MESH_NAMES = tuple(roofline.MESHES)      # 1pod_256, 2pod_512, 1card_h100
CARD_SHARDS = 4         # logical shards of the scan cells' step on one card

# Per-arch training knobs (optimizer family / state dtype / accumulation),
# the reference's: chosen for its v5e HBM budget (EXPERIMENTS.md §Dry-run).
TRAIN_SETTINGS = {
    "nemotron-4-340b": dict(opt="adafactor", state_dtype="float32",
                            n_micro=8, accum="float32"),
    "kimi-k2-1t-a32b": dict(opt="adafactor", state_dtype="float32",
                            n_micro=8, accum="bfloat16"),
    "grok-1-314b": dict(opt="adamw", state_dtype="bfloat16",
                        n_micro=8, accum="float32"),
    "qwen2.5-14b": dict(opt="adamw", state_dtype="float32",
                        n_micro=8, accum="float32"),
    "chatglm3-6b": dict(opt="adamw", state_dtype="bfloat16",
                        n_micro=8, accum="float32"),
    # ZeRO-1 optimizer-state sharding for the 1-10B TP tier
    "qwen3-1.7b": dict(opt="adamw", state_dtype="float32",
                       n_micro=4, accum="float32", zero1=True),
    "zamba2-1.2b": dict(opt="adamw", state_dtype="float32",
                        n_micro=4, accum="float32", zero1=True),
    "paligemma-3b": dict(opt="adamw", state_dtype="float32",
                         n_micro=4, accum="float32", zero1=True),
    # pure DP (sharding.rules.PURE_DP_TRAIN_RULES); n_micro must be 1:
    # global_batch 256 == chip count
    "mamba2-370m": dict(opt="adamw", state_dtype="float32",
                        n_micro=1, accum="float32", pure_dp=True),
    "whisper-small": dict(opt="adamw", state_dtype="float32",
                          n_micro=1, accum="float32", pure_dp=True),
}
DEFAULT_TRAIN = dict(opt="adamw", state_dtype="float32", n_micro=4,
                     accum="float32")

# The paper-technique cell: the distributed secure scan
# (serving/secure_scan.py).  16M encrypted vectors, SIFT dims; the
# suffixed variants are the reference's hillclimb iterations.
PPANNS_CELLS = {
    "scan_16m": dict(n=16_777_216, d=128, batch=1024, k=10, k_prime=128),
    "scan_16m_bf16": dict(n=16_777_216, d=128, batch=1024, k=10,
                          k_prime=128, dtype="bfloat16"),
    "scan_16m_bf16_b4096": dict(n=16_777_216, d=128, batch=4096, k=10,
                                k_prime=128, dtype="bfloat16"),
    "scan_16m_gspmd": dict(n=16_777_216, d=128, batch=1024, k=10,
                           k_prime=128, gspmd=True),
}


def model_flops(cfg: ModelConfig, sc: ShapeConfig) -> float:
    """Analytic 6·N·D (train) / 2·N·D (inference); N_active for MoE."""
    n = n_active_params(cfg)
    if sc.kind == "train":
        return 6.0 * n * sc.global_batch * sc.seq_len
    if sc.kind == "prefill":
        return 2.0 * n * sc.global_batch * sc.seq_len
    return 2.0 * n * sc.global_batch          # decode: 1 token / sequence


def rules_for(shape_name: str, arch: str = ""):
    if shape_name == "train_4k":
        ts = TRAIN_SETTINGS.get(arch, DEFAULT_TRAIN)
        return PURE_DP_TRAIN_RULES if ts.get("pure_dp") else TRAIN_RULES
    if shape_name == "long_500k":
        return LONG_DECODE_RULES
    return SERVE_RULES


def runnable(arch: str, shape_name: str) -> bool:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False          # full-attention archs skip (DESIGN.md §4)
    return True


def all_cells():
    cells = [(arch, shape_name) for arch in ARCHS for shape_name in SHAPES
             if runnable(arch, shape_name)]
    return cells + [("ppanns-scan", name) for name in PPANNS_CELLS]


# ------------------------------------------------------------ the trace

_BLOCK = 512            # the CUDA caching allocator's smallest block


def _sig(a):
    """What a meta op's result depends on, hashable; TypeError where an
    argument has no such form."""
    if isinstance(a, torch.Tensor):
        return ("T", tuple(a.shape), a.stride(), a.dtype, a.device.type)
    if isinstance(a, (list, tuple)):
        return tuple(_sig(x) for x in a)
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return (type(a).__name__, a)
    raise TypeError(type(a))


class StepTrace(TorchDispatchMode):
    """Live device bytes and FLOPs of a step run on `meta` tensors.

    `tensors` are the step's arguments (live before it starts).  Each new
    meta storage an op makes adds its bytes, rounded up to the caching
    allocator's 512-byte block, when it is made, and takes them off when
    it is freed (a finalizer on the storage, which torch keeps while any
    tensor, view or autograd record holds it); `peak` is the most live
    at once.  `flops` sums FlopCounterMode's formulas (`flop_registry`)
    over the ops, decomposing an op that has none as FlopCounterMode
    does.  An op whose results are fresh tensors runs its meta function
    once a signature (op, shapes, strides, dtypes, other arguments); its
    results are made from the remembered shapes after that, so identical
    layers and microbatches cost one meta computation."""

    def __init__(self, tensors=()):
        super().__init__()
        self.live = self.peak = 0
        self.flops = 0
        self._seen: set[int] = set()
        self._known: dict = {}
        self._fresh: dict = {}           # op -> its results are fresh
        self._whole: set = set()         # ops that do not decompose
        for t in tensors:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = -(-st.nbytes() // _BLOCK) * _BLOCK
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fresh = self._fresh.get(func)
        if fresh is None:
            s = func._schema
            fresh = self._fresh[func] = not s.is_mutable and all(
                r.alias_info is None and str(r.type) == "Tensor"
                for r in s.returns)
        key = None
        if fresh:
            try:
                key = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
            except TypeError:
                key = None
        known = self._known.get(key) if key is not None else None
        if known is not None:
            metas, flops = known
            outs = tuple(torch.empty_strided(shape, stride, dtype=dt,
                                             device="meta")
                         for shape, stride, dt in metas)
            out = outs[0] if len(func._schema.returns) == 1 else outs
        else:
            packet = func._overloadpacket
            if packet not in flop_registry and func not in self._whole:
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
                self._whole.add(func)
            out = func(*args, **kwargs)
            flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                     if packet in flop_registry else 0)
            if key is not None:
                res = [out] if len(func._schema.returns) == 1 else out
                self._known[key] = ([(tuple(t.shape), t.stride(), t.dtype)
                                     for t in res], flops)
        self.flops += flops
        for t in (out,) if isinstance(out, torch.Tensor) else \
                tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _trace(step, args, extra=()) -> dict:
    """Run step(*args) under a StepTrace; args and `extra` (tensors the
    step reads beside them, the model's weights) are live from the
    start.  -> the trace's numbers; the outputs are dropped."""
    tensors = _tensors(args) + list(extra)
    t0 = time.perf_counter()
    tr = StepTrace(tensors)
    with tr:
        out = step(*args)
    peak, flops = tr.peak, tr.flops
    del out
    return {"peak_bytes": peak, "flops": float(flops),
            "trace_s": time.perf_counter() - t0}


# ------------------------------------------------------ bytes per device

def make_dryrun_mesh(mesh_name: str):
    """The named mesh (roofline.MESHES) over logical host devices."""
    shape = roofline.MESHES[mesh_name]
    force_device_count(math.prod(shape.values()))
    try:
        return make_mesh(tuple(shape.values()), tuple(shape), "cpu")
    finally:
        force_device_count(None)


def _dtype(d) -> torch.dtype:
    return getattr(torch, d) if isinstance(d, str) else d


def shard_bytes(shape, dtype, spec, mesh) -> int:
    """Bytes of one device's block of a tensor placed by `spec`: a
    dimension named by mesh axes is cut into as many equal blocks as
    they hold devices (strict specs divide evenly)."""
    parts = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
    n = 1
    for dim, p in zip(shape, parts):
        names = () if not p else ((p,) if isinstance(p, str) else p)
        n *= dim // math.prod(mesh.shape[a] for a in names)
    return n * _dtype(dtype).itemsize


def _tree_bytes(values, specs, mesh) -> int:
    """Per-device bytes of a tree of metas (ParamMeta or tensors) by the
    tree of their specs, walked together."""
    if isinstance(values, dict):
        if set(values) != set(specs):
            raise ValueError(f"values and specs differ: {sorted(values)} "
                             f"against {sorted(specs)}")
        return sum(_tree_bytes(values[k], specs[k], mesh) for k in values)
    return shard_bytes(tuple(values.shape), values.dtype, specs, mesh)


def _metas_bytes(metas: dict, mesh, rules, skip=("pos",)) -> int:
    kept = {k: m for k, m in metas.items() if k not in skip}
    return _tree_bytes(kept, param_pspecs(kept, mesh, rules), mesh)


# ------------------------------------------------------------ the cells

def _train_args(model, cfg, sc, ts: dict):
    opt_cfg = OptConfig(kind=ts["opt"], state_dtype=ts["state_dtype"])
    state = init_train_state(model, opt_cfg)
    batch = {k: torch.empty(m.shape, dtype=_dtype(m.dtype), device="meta")
             for k, m in batch_metas(cfg, sc).items()}
    return opt_cfg, state, batch


def _lm_record(arch: str, cfg: ModelConfig, sc: ShapeConfig, mesh_name: str,
               mesh, ts: dict | None, trace: bool) -> dict:
    rules = rules_for(sc.name, arch) if sc.name in SHAPES else (
        TRAIN_RULES if sc.kind == "train" else SERVE_RULES)
    model = Model(cfg, device="meta", seed=None)
    rec = {"model_flops": model_flops(cfg, sc), "n_params": n_params(cfg),
           "n_active_params": n_active_params(cfg)}
    B, T = sc.global_batch, sc.seq_len
    batch_b = _metas_bytes(batch_metas(cfg, sc), mesh, rules)
    dtb = _dtype(cfg.dtype).itemsize
    if sc.kind == "train":
        ts = ts or TRAIN_SETTINGS.get(arch, DEFAULT_TRAIN)
        opt_cfg = OptConfig(kind=ts["opt"], state_dtype=ts["state_dtype"])
        state = abstract_train_state(model, opt_cfg)
        specs = train_state_pspecs(model, opt_cfg, mesh, rules,
                                   zero1=bool(ts.get("zero1")))
        state_b = _tree_bytes({k: state[k] for k in ("params", "opt")},
                              {k: specs[k] for k in ("params", "opt")}, mesh)
        rec["train_settings"] = ts
        mem = {"argument_bytes": state_b + batch_b,
               "output_bytes": state_b + 2 * 4,      # + loss, grad_norm
               "alias_bytes": 0}
    else:
        cache_b = _metas_bytes(cache_metas(cfg, B, T), mesh, rules)
        weights_b = _metas_bytes(model.param_metas(), mesh, rules)
        mem = {"argument_bytes": weights_b + batch_b + cache_b,
               "output_bytes": B * cfg.vocab_size * dtb + cache_b,
               "alias_bytes": cache_b}               # written in place
    rec["memory"] = mem

    if trace:
        if sc.kind == "train":
            opt_cfg, state, batch = _train_args(model, cfg, sc, ts)
            step = build_train_step(model, opt_cfg,
                                    n_microbatches=ts["n_micro"],
                                    accum_dtype=ts["accum"])
            got = _trace(step, (state, batch))
        else:
            batch = {k: torch.empty(m.shape, dtype=_dtype(m.dtype),
                                    device="meta")
                     for k, m in batch_metas(cfg, sc).items()}
            cache = model.init_cache(B, T)
            if sc.kind == "prefill":
                got = _trace(model.prefill, (batch, cache),
                             list(model.parameters()))
            else:         # one new token against a T-long cache
                cache["pos"] = T - 1
                got = _trace(model.decode_step, (batch["tokens"], cache),
                             list(model.parameters()))
        rec["cost"] = {"flops": got["flops"],
                       "counter": "FlopCounterMode formulas"}
        rec["trace_s"] = round(got["trace_s"], 2)
        mem["peak_bytes"] = got["peak_bytes"]
        mem["temp_bytes"] = got["peak_bytes"] - mem["argument_bytes"]
    return rec


def _scan_record(shape_name: str, mesh_name: str, mesh, trace: bool) -> dict:
    from ..serving.secure_scan import (build_secure_scan_step,
                                       build_secure_scan_step_gspmd,
                                       secure_scan_input_specs,
                                       secure_scan_pspecs)
    cell = PPANNS_CELLS[shape_name]
    dtype = cell.get("dtype", "float32")
    rec = {"model_flops": 2.0 * cell["n"] * cell["d"] * cell["batch"],
           "n_params": 0, "cell_dtype": dtype, "operand_dtype": dtype}
    specs = secure_scan_input_specs(cell["n"], cell["d"], cell["batch"],
                                    dtype=_dtype(dtype))
    split = secure_scan_pspecs(None)
    axes = tuple(mesh.shape)
    args = {k: shard_bytes(tuple(t.shape), t.dtype,
                           [axes if split[k] == 0 else None], mesh)
            for k, t in specs.items()}
    out_b = cell["batch"] * cell["k"] * 8               # ids, int64
    rec["memory"] = {"argument_bytes": sum(args.values()),
                     "output_bytes": out_b, "alias_bytes": 0,
                     "arguments": args}
    if trace:
        meta = torch.device("meta")
        if cell.get("gspmd"):
            step = build_secure_scan_step_gspmd([meta], k=cell["k"],
                                                k_prime=cell["k_prime"])
        else:
            step = build_secure_scan_step([meta] * CARD_SHARDS, k=cell["k"],
                                          k_prime=cell["k_prime"])
            rec["shards"] = CARD_SHARDS
        got = _trace(step, (specs["C_sap"], specs["C_dce"], specs["Q_sap"],
                            specs["T_q"]))
        rec["cost"] = {"flops": got["flops"],
                       "counter": "FlopCounterMode formulas; K1 and K2 "
                                  "are opaque to it"}
        rec["trace_s"] = round(got["trace_s"], 2)
        rec["memory"]["peak_bytes"] = got["peak_bytes"]
        rec["memory"]["temp_bytes"] = (got["peak_bytes"]
                                       - rec["memory"]["argument_bytes"])
    return rec


def cell_record(arch: str, shape_name: str, mesh_name: str, *,
                cfg: ModelConfig | None = None, sc: ShapeConfig | None = None,
                train_settings: dict | None = None,
                trace: bool | None = None) -> dict:
    """One cell's dry-run record on the named mesh (never raises: a cell
    that fails is `ok: false` with its error).  `cfg`, `sc` and
    `train_settings` replace the registry's (a phase's own sizes);
    `trace` defaults to True on 1card_h100, the one mesh that traces."""
    if trace is None:
        trace = mesh_name == "1card_h100"
    if trace and mesh_name != "1card_h100":
        raise ValueError("only the 1card_h100 mesh traces a step")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False,
           "chips": math.prod(roofline.MESHES[mesh_name].values())}
    t0 = time.perf_counter()
    try:
        mesh = make_dryrun_mesh(mesh_name)
        if arch == "ppanns-scan":
            rec.update(_scan_record(shape_name, mesh_name, mesh, trace))
        else:
            cfg = cfg or get_config(arch)
            sc = sc or SHAPES[shape_name]
            rec.update(_lm_record(arch, cfg, sc, mesh_name, mesh,
                                  train_settings, trace))
        mem = rec["memory"]
        mem.setdefault("peak_bytes", None)
        mem.setdefault("temp_bytes", None)
        rec.setdefault("cost", {"flops": None})
        rec["fits_one_card"] = (None if mem["peak_bytes"] is None else
                                mem["peak_bytes"]
                                <= roofline.H100_MEMORY_BYTES)
        if arch == "ppanns-scan" or rec["chips"] == 1:
            coll = {}
        else:
            coll = roofline.exec_collectives(
                cfg, sc, arch, roofline.MESHES[mesh_name])
        rec["collectives"] = dict(coll, total=coll.get("total", 0.0),
                                  analytic=True)
        rec["ok"] = True
    except Exception as e:                        # noqa: BLE001
        # a cell that fails to trace is recorded, never dropped
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: str = RESULTS_DIR, verbose: bool = True,
             trace: bool | None = None) -> dict:
    """cell_record, written to out_dir/{arch}__{shape}__{mesh}.json."""
    rec = cell_record(arch, shape_name, mesh_name, trace=trace)
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        status = ("OK" if rec["ok"]
                  else f"FAIL ({rec.get('error', '')[:120]})")
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: {status} "
              f"({rec['total_s']}s)", flush=True)
    return rec


def _run_all(meshes: list[str], out_dir: str, jobs: int) -> int:
    """One subprocess a cell (all of `meshes` in it), `jobs` at once.
    -> the number of cells whose process failed."""
    out_dir = os.path.abspath(out_dir)
    src = str(Path(__file__).resolve().parents[2])
    cmds = []
    # the train cells first (they trace longest), so none is left last
    for arch, shape_name in sorted(all_cells(),
                                   key=lambda c: c[1] != "train_4k"):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape_name, "--out", out_dir]
        for m in meshes:
            cmd += ["--mesh", m]
        cmds.append(cmd)
    running, failed, t0 = [], 0, time.perf_counter()
    n_cells = len(cmds)
    try:
        while cmds or running:
            while cmds and len(running) < jobs:
                running.append(subprocess.Popen(cmds.pop(0), cwd=src))
            time.sleep(0.05)
            for p in [p for p in running if p.poll() is not None]:
                failed += p.returncode != 0
                running.remove(p)
    finally:
        for p in running:
            p.kill()
            p.wait()
    print(f"[dryrun] all: {n_cells} cells x {len(meshes)} meshes in "
          f"{time.perf_counter() - t0:.1f} s, {failed} cells failed",
          flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", action="append", choices=MESH_NAMES,
                    help="repeatable (default: 1pod_256)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="1pod_256 and 2pod_512")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells run at once")
    args = ap.parse_args(argv)
    meshes = list(dict.fromkeys(
        (["1pod_256", "2pod_512"] if args.both_meshes else [])
        + (args.mesh or [])))
    meshes = meshes or ["1pod_256"]
    if args.all:
        return 1 if _run_all(meshes, args.out, max(1, args.jobs)) else 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    recs = [run_cell(args.arch, args.shape, m, args.out) for m in meshes]
    return 0 if all(r["ok"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
