"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the metrics the cell reports.

The path driven is the server's batched Algorithm 2,
`repro_torch.serving.search_engine.SecureSearchEngine.search_batch`:

  set-up   the base set and a query pool from --seed (`datagen`); the
           data owner (`core.ppanns.DataOwner`, beta from
           `core.dcpe.suggest_beta`) encrypts the base set with
           `encrypt_vectors`; the user encrypts the pool (`dcpe.encrypt`,
           `dce.trapgen`), as a client would before sending; the engine
           is built and its first `search_batch` uploads the ciphertexts
           and attaches the filter; a few more batches of the cell's one
           shape warm it.  Set-up ends where the window starts.
  window   one client sends the pool's batches in turn, as numpy
           ciphertexts, each when the last one's ids are on the host (a
           closed loop), for `seconds` and once round the pool at
           least.  With a trace the window is two stretches:
           torch.profiler over the first half (device busy time, the
           breakdown), the program's kernel profiler over the
           second (device time of each entry, which synchronises after
           every call).
  check    once the window has closed and the memory peak is read, the
           program's state is freed and the reference answers every
           query of the pool (`reference`); every answer of the window
           is compared with it (`compare`).

Nothing here decides whether a card is present: `run.py` does, and the
tests drive this module on the host with device "cpu".
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import compare, datagen, reference, spec, tracing

__all__ = ["Cell", "Context", "WARM_BATCHES", "run"]

WARM_BATCHES = 3            # batches after the first, before the window


@dataclass
class Cell:
    """What a run needs of its cell, as loaded from its files."""
    name: str
    cfg: dict
    traffic: dict
    limits: dict
    metrics: list = field(default_factory=list)

    @classmethod
    def load(cls, name: str, trace: bool) -> "Cell":
        w = spec.workload(name)
        return cls(name, spec.config(w["config"]), spec.traffic(w["traffic"]),
                   spec.limits(name), spec.metrics_of(name, trace))


@dataclass
class Context:
    """What the metric readers (`metrics/<name>.py`) read."""
    cfg: dict
    traffic: dict
    shape: dict                       # nq, n, d, kp, k of a batch
    setup: dict = field(default_factory=dict)
    window: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    kernels: dict | None = None       # the kernel profiler's summary
    kernel_batches: int = 0           # batches it timed
    trace: dict | None = None         # `tracing.reduce` of the stretch


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _drive(engine, batches, k, ratio_k, until, log, least=1, label=False):
    """Send batches back to back until the clock passes `until` and at
    least `least` have gone; the batch in flight then finishes.
    Returns the stretch's seconds."""
    t0 = t1 = time.perf_counter()
    n, first = len(batches), log["sent"]
    while t1 < until or log["sent"] - first < least:
        b = log["sent"] % n
        q, t = batches[b]
        tq = time.perf_counter()
        with (torch.profiler.record_function("bench.search_batch") if label
              else contextlib.nullcontext()):
            ids, stats = engine.search_batch(q, t, k, ratio_k=ratio_k)
        t1 = time.perf_counter()
        log["latency_s"].append(t1 - tq)
        log["ids"].append(ids)
        log["batch"].append(b)
        log["sent"] += 1
        log["refine_comparisons"] += stats.refine_comparisons
        log["n_queries"] += stats.n_queries
    return t1 - t0


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, patch=None) -> dict:
    """One run; returns the fields of the result line (`run.py` prints
    them).  `patch(engine)`, for the tests, may replace the engine's
    methods after set-up (a broken timed path)."""
    from repro_torch.core import dce, dcpe
    from repro_torch.core.ppanns import DataOwner
    from repro_torch.obs.profiler import profile_kernels
    from repro_torch.serving.search_engine import SecureSearchEngine

    device = torch.device(device)
    cfg, mix = cell.cfg, cell.traffic
    sd = datagen.seeds(seed)
    k, ratio_k = int(mix["k"]), float(cfg["ratio_k"])
    n, d = int(cfg["n"]), int(cfg["d"])
    slices = datagen.batches(mix)
    ctx = Context(cfg, mix, {"nq": int(mix["batch"]), "n": n, "d": d,
                             "kp": reference.filter_width(cfg, k), "k": k})

    # -- set-up: inputs, owner, user, engine --------------------------
    P_dev, Q_dev = datagen.mixture(cfg, int(mix["pool"]), sd["data"], device)
    P, Q = P_dev.cpu().numpy(), Q_dev.cpu().numpy()
    del P_dev, Q_dev
    owner = DataOwner(d, sap_beta=dcpe.suggest_beta(
        P, fraction=float(cfg["beta_fraction"])),
        sap_s=float(cfg["sap_s"]), seed=sd["owner_keys"])
    t = time.perf_counter()
    C_sap, C_dce = owner.encrypt_vectors(P, seed=sd["owner_noise"],
                                         device=device)
    ctx.setup["encrypt_s"] = time.perf_counter() - t
    keys = owner.share_keys()
    Q_sap = dcpe.encrypt(Q, keys.sap_key, seed=sd["user_sap"])
    T_q = dce.trapgen(Q, keys.dce_key, seed=sd["user_trap"])
    batches = [(np.ascontiguousarray(Q_sap[s]), np.ascontiguousarray(T_q[s]))
               for s in slices]
    del Q_sap, T_q
    engine_kw = dict(backend=cfg["engine"]["backend"],
                     quantization=cfg["engine"]["quantization"])
    if engine_kw["quantization"] is not None:
        engine_kw["refine_ratio"] = float(cfg["refine_ratio"])
    engine = SecureSearchEngine(C_sap, C_dce, device=device, **engine_kw)
    del C_sap, C_dce
    t = time.perf_counter()
    engine.search_batch(*batches[0], k, ratio_k=ratio_k)
    ctx.setup["first_batch_s"] = time.perf_counter() - t
    for b in range(1, 1 + WARM_BATCHES):
        engine.search_batch(*batches[b % len(batches)], k, ratio_k=ratio_k)
    if trace:                 # start each profiler once outside the window
        with torch.profiler.profile(activities=_activities(device)):
            engine.search_batch(*batches[0], k, ratio_k=ratio_k)
        with profile_kernels():
            engine.search_batch(*batches[0], k, ratio_k=ratio_k)
    if patch is not None:
        patch(engine)
    _sync(device)
    peak_setup = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # -- the window ---------------------------------------------------
    log = {"sent": 0, "latency_s": [], "ids": [], "batch": [],
           "refine_comparisons": 0, "n_queries": 0}
    t0 = time.perf_counter()
    ctx.setup["setup_s"] = t0 - t_start
    if not trace:
        window_s = _drive(engine, batches, k, ratio_k, t0 + seconds, log,
                          least=len(batches))
    else:
        with torch.profiler.profile(activities=_activities(device)) as prof:
            traced_s = _drive(engine, batches, k, ratio_k,
                              t0 + seconds / 2, log, least=len(batches),
                              label=True)
            _sync(device)
        sent = log["sent"]
        with profile_kernels() as kprof:
            _drive(engine, batches, k, ratio_k, t0 + seconds, log)
        window_s = time.perf_counter() - t0
        ctx.kernels = kprof.summary()
        ctx.kernel_batches = log["sent"] - sent
        ctx.trace = tracing.reduce(prof.events())
        ctx.trace["window_s"] = traced_s
    _sync(device)
    peak_window = _peak(device)
    ctx.window = {"seconds": window_s, "latency_s": log["latency_s"],
                  "memory_peak": peak_window}
    ctx.counters = {"refine_comparisons": log["refine_comparisons"],
                    "n_queries": log["n_queries"]}

    # -- the check, with the program's state freed ---------------------
    del engine, batches, owner, keys
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = np.concatenate(log["ids"])
    rows = np.concatenate([np.arange(slices[b].start, slices[b].stop)
                           for b in log["batch"]])
    want, cand = reference.answers(cfg, k, P, Q, sd, device)
    values = compare.measure(got, rows, want, cand)
    checks = compare.judge(values, cell.limits)
    failed = int((got < 0).any(axis=1).sum())
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    metrics = {}
    for m in cell.metrics:
        value = spec.part("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "host"),
           "count": 1, "memory_peak_bytes": max(peak_setup, peak_window)}
    out = {"correct": correct, "attempted": log["n_queries"],
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx.trace["busy_s"]
        dev["window_s"] = ctx.trace["window_s"]
        out["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                            "idle_gaps": ctx.trace["idle_gaps"]}
    first = slice(0, int(mix["pool"]))       # one pass over the pool
    out["explain"] = {**values, "gaps": compare.gaps(
        got[first], want[rows[first]], P, Q[rows[first]])}
    out["checks"] = checks                   # the result line's last key
    return out


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
