"""Roofline analysis of the dry-run cells for the NVIDIA H100 SXM, the
counterpart of `repro.launch.roofline` (which models a TPU v5e).

Three terms per (arch x shape x mesh):
    compute    = exec_FLOPs / (chips * peak)          [bf16 tensor cores;
                                                        fp32 CUDA cores
                                                        for the scan cells]
    memory     = exec_bytes / (chips * HBM_BW)        [HBM3]
    collective = coll_bytes_per_chip / LINK_BW        [one network link]

The constants are the H100 SXM's published dense peaks (NVIDIA H100
Tensor Core GPU data sheet, SXM part, no sparsity): 989 TFLOP/s in bf16,
67 TFLOP/s in fp32 outside the tensor cores, 1,979 TOP/s in int8, 3.35
TB/s of HBM3.  LINK_BW is one 400 Gb/s NDR InfiniBand port a GPU (50
GB/s): the link a 256- or 512-card mesh of 8-GPU nodes crosses.
NVLink's 450 GB/s each way inside a node is not split out, just as the
reference models one link.  No TPU figure is used.

The counts are the reference's first-principles models, formula for
formula (`exec_flops`, `exec_bytes`, `_cache_bytes`, `exec_collectives`
count every layer, microbatch and remat pass), so a count here equals
the reference's for every cell.  They take a config and never build a
`Model`: parameter counts come from the metas (`models.model.n_params`,
`n_active_params`), so kimi-k2's 1T weights are never allocated.
Two kept differences:
  * the mesh `1card_h100` (chips 1): a mesh of one card crosses no
    link, so its collective term is 0;
  * the `ppanns-scan` cells compute in true fp32 on the CUDA cores (K1
    and K2 under `device.full_fp32`), so their compute term and
    `fraction_of_roofline` use the fp32 peak; an LM cell uses the peak
    of its dtype.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

from ..configs import get_config
from ..models.config import SHAPES, ModelConfig, ShapeConfig
from ..models.model import n_active_params, n_params

__all__ = ["PEAK_BF16_FLOPS", "PEAK_FP32_FLOPS", "PEAK_INT8_OPS", "HBM_BW",
           "LINK_BW", "H100_MEMORY_BYTES", "MESHES", "exec_flops",
           "exec_bytes", "exec_collectives", "RooflineRow", "analyze_record",
           "load_records", "table", "format_table"]

# ---- hardware constants (NVIDIA H100 SXM data sheet, dense)
PEAK_BF16_FLOPS = 989e12     # bf16 on the tensor cores
PEAK_FP32_FLOPS = 67e12      # fp32 FMA outside the tensor cores
PEAK_INT8_OPS = 1979e12      # int8 on the tensor cores
HBM_BW = 3.35e12             # bytes/s of HBM3
LINK_BW = 50e9               # bytes/s: one 400 Gb/s NDR port a card
# `torch.cuda.get_device_properties(0).total_memory` of an H100 80GB
# HBM3 (chip_smoke.py checks it against the card it runs on)
H100_MEMORY_BYTES = 85_017_493_504

# mesh name -> axis sizes: the reference's two production meshes and one
# card
MESHES = {"1pod_256": {"data": 16, "model": 16},
          "2pod_512": {"pod": 2, "data": 16, "model": 16},
          "1card_h100": {"data": 1, "model": 1}}

BYTES = {"bfloat16": 2, "float32": 4, "float16": 2, "int32": 4}


def _train_settings(arch: str) -> dict:
    from .dryrun import DEFAULT_TRAIN, TRAIN_SETTINGS
    return TRAIN_SETTINGS.get(arch, DEFAULT_TRAIN)


# ===================================================================
# Analytic FLOPs (counting every loop iteration)
# ===================================================================

def exec_flops(cfg: ModelConfig, sc: ShapeConfig) -> dict:
    B, S = sc.global_batch, sc.seq_len
    n_act = n_active_params(cfg)
    H, dh, L = cfg.n_heads, cfg.head_dim, cfg.n_layers

    if sc.kind == "train":
        tokens, mult = B * S, (4.0 if cfg.remat else 3.0)   # fwd+bwd+refwd
    elif sc.kind == "prefill":
        tokens, mult = B * S, 1.0
    else:
        tokens, mult = B, 1.0

    matmul = 2.0 * n_act * tokens * mult

    attn = 0.0
    if cfg.family in ("dense", "moe", "vlm"):
        T = S
        q_len = S if sc.kind != "decode" else 1
        # the full (S, T) rectangle (no causal skip)
        attn = L * 4.0 * B * q_len * T * H * dh * mult
    elif cfg.family == "encdec":
        Se = cfg.enc_seq_len
        q_len = S if sc.kind != "decode" else 1
        enc = (cfg.n_enc_layers * 4.0 * B * Se * Se * H * dh
               if sc.kind != "decode" else 0.0)
        self_a = L * 4.0 * B * q_len * S * H * dh
        cross = L * 4.0 * B * q_len * Se * H * dh
        attn = (enc + self_a + cross) * mult
    elif cfg.family in ("ssm", "hybrid"):
        Hs, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        q = 128 if sc.kind != "decode" else 1
        tok = B * S if sc.kind != "decode" else B
        # SSD: within-chunk ~2*tok*q*(N+P) per head + states ~4*N*P
        ssd = L * 2.0 * tok * Hs * (q * (N + P) + 2.0 * N * P) * mult
        attn += ssd
        if cfg.family == "hybrid":
            every = max(cfg.attn_every, 1)
            n_slots = sum(1 for i in range(L) if i % every == 0)
            q_len = S if sc.kind != "decode" else 1
            attn += n_slots * 4.0 * B * q_len * S * H * dh * mult
    return {"matmul": matmul, "attn_ssm": attn, "total": matmul + attn}


# ===================================================================
# Analytic HBM bytes (per step, summed over chips)
# ===================================================================

def exec_bytes(cfg: ModelConfig, sc: ShapeConfig, arch: str) -> dict:
    n = n_params(cfg)
    p_bytes = n * BYTES[cfg.dtype]
    B, S = sc.global_batch, sc.seq_len
    d = cfg.d_model

    if sc.kind == "train":
        ts = _train_settings(arch)
        opt_b = {"adamw": 2, "sgdm": 1, "adafactor": 0.02}[ts["opt"]] \
            * n * BYTES[ts["state_dtype"]]
        grad_b = n * BYTES[ts["accum"]]
        tokens = B * S
        # weights: read fwd + bwd + remat refwd; grads: w+r; opt: r+w.
        # pure_dp replicates weights: every chip reads the full model, so
        # the global-equivalent traffic scales by the chip count.
        rep = 256 if ts.get("pure_dp") else 1
        weights = 3 * p_bytes * rep
        opt = 2 * opt_b + 2 * grad_b
        # layer-boundary activation checkpoints: write + read (bf16)
        acts = 2 * cfg.n_layers * tokens * d * 2
        logits = 2 * tokens * cfg.vocab_size * 2 / max(
            1, ts["n_micro"]) * ts["n_micro"]     # streamed per microbatch
        total = weights + opt + acts + logits
        return {"weights": weights, "opt_grads": opt, "activations": acts,
                "logits": logits, "total": total}

    if sc.kind == "prefill":
        tokens = B * S
        cache = _cache_bytes(cfg, B, S)
        acts = 2 * cfg.n_layers * tokens * d * 2
        total = p_bytes + cache + acts
        return {"weights": p_bytes, "cache_write": cache,
                "activations": acts, "total": total}

    # decode: read active weights + read the whole cache, write 1 row
    n_act_b = n_active_params(cfg) * BYTES[cfg.dtype]
    cache = _cache_bytes(cfg, B, S)
    total = n_act_b + cache
    return {"weights": n_act_b, "cache_read": cache, "total": total}


def _cache_bytes(cfg: ModelConfig, B: int, T: int) -> float:
    dtb = BYTES[cfg.dtype]
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        c = 2 * cfg.n_layers * B * T * cfg.n_kv_heads * cfg.head_dim * dtb
        if cfg.family == "encdec":
            c += 2 * cfg.n_layers * B * cfg.enc_seq_len * \
                cfg.n_kv_heads * cfg.head_dim * dtb
        return c
    conv_d = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    c = cfg.n_layers * B * (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                            * 4 + (cfg.ssm_conv - 1) * conv_d * dtb)
    if cfg.family == "hybrid":
        every = max(cfg.attn_every, 1)
        n_slots = sum(1 for i in range(cfg.n_layers) if i % every == 0)
        c += 2 * n_slots * B * T * cfg.n_kv_heads * cfg.head_dim * dtb
    return c


# ===================================================================
# Analytic collective bytes (per chip per step)
# ===================================================================

def exec_collectives(cfg: ModelConfig, sc: ShapeConfig, arch: str,
                     mesh_shape: dict) -> dict:
    n = n_params(cfg)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    tp = mesh_shape.get("model", 1)
    p_bytes = n * BYTES[cfg.dtype]
    B, S = sc.global_batch, sc.seq_len
    d = cfg.d_model
    out: dict[str, float] = {}

    if sc.kind == "train":
        ts = _train_settings(arch)
        if ts.get("pure_dp"):
            # no TP: the only collective is the full-tree gradient
            # all-reduce over all chips (ring: ~2x bytes)
            out["dp_gradsync"] = 2 * n * BYTES[ts["accum"]]
            out["total"] = sum(out.values())
            return out
        tokens_dev = B * S / dp
        n_ar = {"dense": 2, "moe": 3, "vlm": 2, "encdec": 4,
                "ssm": 2, "hybrid": 2}[cfg.family]
        # TP activation all-reduces: fwd + bwd + remat refwd (~3x), ring 2x
        out["tp_allreduce"] = (cfg.n_layers * n_ar * 3 * 2
                               * tokens_dev * d * 2)
        # DP gradient sync: ~2x local grad shard bytes
        out["dp_gradsync"] = 2 * (p_bytes / tp) * BYTES[ts["accum"]] / 2
        if cfg.fsdp:
            # ZeRO-3 weight all-gather per microbatch (fwd+bwd+refwd)
            out["fsdp_allgather"] = 3 * ts["n_micro"] * (p_bytes / tp)
        if cfg.family == "moe":
            # dispatch/combine cross-device token movement ~2x token bytes*k
            out["moe_alltoall"] = (2 * tokens_dev * d * 2
                                   * cfg.experts_per_token)
    elif sc.kind == "prefill":
        tokens_dev = B * S / max(dp, 1)
        n_ar = 2
        out["tp_allreduce"] = cfg.n_layers * n_ar * tokens_dev * d * 2
    else:  # decode
        b_dev = max(B / dp, 1)
        out["tp_allreduce"] = cfg.n_layers * 2 * b_dev * d * 2
        # flash-decode partial-softmax combine over the seq-sharded cache
        if cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            out["softmax_combine"] = (cfg.n_layers * b_dev
                                      * cfg.n_heads * cfg.head_dim * 4 * 2)
    out["total"] = sum(out.values())
    return out


# ===================================================================
# Assembly
# ===================================================================

@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    exec_flops_total: float
    useful_ratio: float
    hlo_flops_raw: float
    note: str = ""
    peak_flops: float = PEAK_BF16_FLOPS

    def fraction_of_roofline(self) -> float:
        """useful model flops / (time-if-run-at-dominant-term * peak)."""
        t = max(self.compute_s, self.memory_s, self.collective_s)
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * self.peak_flops)


def analyze_record(rec: dict) -> RooflineRow | None:
    arch, shape, mesh = rec["arch"], rec["shape"], rec["mesh"]
    if not rec.get("ok"):
        return None
    mesh_shape = MESHES[mesh]
    chips = 1
    for size in mesh_shape.values():
        chips *= size

    if arch == "ppanns-scan":
        # filter matmul dominates: 2*n*d flops per query + norm adds
        from .dryrun import PPANNS_CELLS
        cell = PPANNS_CELLS[shape]
        dtb = 2.0 if cell.get("dtype") == "bfloat16" else 4.0
        fl = 2.0 * cell["n"] * cell["d"] * cell["batch"]
        # filter reads C_sap once; refine reads only B*k' DCE rows
        by = (cell["n"] * cell["d"] * dtb
              + cell["batch"] * cell["k_prime"] * 4 * (2 * cell["d"] + 16)
              * dtb)
        if cell.get("gspmd"):
            # the (B, n) matrix is globally gathered for the top-k
            by += cell["batch"] * cell["n"] * 4.0
            coll = cell["batch"] * cell["n"] * 4.0 / chips
        else:
            coll = cell["batch"] * cell["k_prime"] * 8.0
        comp = fl / (chips * PEAK_FP32_FLOPS)
        mem = by / (chips * HBM_BW)
        cols = coll / LINK_BW if chips > 1 else 0.0
        dom = max((comp, "compute"), (mem, "memory"), (cols, "collective"))
        return RooflineRow(arch, shape, mesh, chips, comp, mem, cols,
                           dom[1], fl, fl, 1.0,
                           rec.get("cost", {}).get("flops", -1),
                           "filter scan, fp32 FMA on the CUDA cores",
                           PEAK_FP32_FLOPS)

    cfg = get_config(arch)
    sc = SHAPES[shape]
    peak = PEAK_FP32_FLOPS if cfg.dtype == "float32" else PEAK_BF16_FLOPS
    ef = exec_flops(cfg, sc)
    eb = exec_bytes(cfg, sc, arch)
    comp = ef["total"] / (chips * peak)
    mem = eb["total"] / (chips * HBM_BW)
    cols = (exec_collectives(cfg, sc, arch, mesh_shape)["total"] / LINK_BW
            if chips > 1 else 0.0)        # already per chip
    dom = max((comp, "compute"), (mem, "memory"), (cols, "collective"))
    mf = rec.get("model_flops", 0.0)
    return RooflineRow(
        arch, shape, mesh, chips, comp, mem, cols, dom[1], mf,
        ef["total"], mf / ef["total"] if ef["total"] else 0.0,
        rec.get("cost", {}).get("flops", -1), peak_flops=peak)


def load_records(results_dir: str = "results/dryrun_torch") -> list[dict]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def table(results_dir: str = "results/dryrun_torch",
          mesh_filter: str = "1pod_256") -> list[RooflineRow]:
    rows = []
    for rec in load_records(results_dir):
        if mesh_filter and rec.get("mesh") != mesh_filter:
            continue
        r = analyze_record(rec)
        if r is not None:
            rows.append(r)
    return rows


def format_table(rows: list[RooflineRow]) -> str:
    hdr = (f"{'arch':<18}{'shape':<21}{'compute_s':>11}{'memory_s':>11}"
           f"{'coll_s':>10}{'dominant':>11}{'MF/EF':>7}{'roofl%':>8}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:<18}{r.shape:<21}{r.compute_s:>11.4g}"
            f"{r.memory_s:>11.4g}{r.collective_s:>10.4g}{r.dominant:>11}"
            f"{r.useful_ratio:>7.2f}{100 * r.fraction_of_roofline():>7.1f}%")
    return "\n".join(lines)
