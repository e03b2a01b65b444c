"""The engine's search, distribution-native: the sharded secure-scan
step (DESIGN.md §3, §4), the counterpart of `repro.serving.secure_scan`.

The encrypted database (DCPE filter ciphertexts + DCE refine
ciphertexts) is split row-wise over the placement devices (the list
`launch.mesh.local_devices` gives, where the JAX package takes a mesh);
a batch of encrypted queries runs

  filter:  the fused l2_topk kernel (K1) once per shard over its rows
           -> per-shard top-k' with global ids -> the cross-shard merge
           (`sharded.merge_shard_topk`: k' candidates a shard, never the
           (B, n) distance matrix)
  refine:  the fused dce_comp refine (K2) over the merged candidates on
           the device holding the DCE ciphertexts -> exact top-k

`build_secure_scan_step_gspmd` is the global formulation beside it: one
K1 scan over all rows, then the same refine.  Both compute the same
answer; they differ only in how the scan is cut.

The operands may be float32, bfloat16 or float16, each on its own (the
reference's bf16 cells round all four; a bf16 filter with a float32
refine is the form that keeps DCE's exactness): K1 and K2 read C_sap and
C_dce in place and compute in float32, as the reference's Pallas
kernels do after their cast, so no float32 copy of a corpus is made.
The reference's XLA filter inside its shard_map computes `Q @ C.T` in
the operand dtype instead; the port follows the kernels.
"""

from __future__ import annotations

import torch

from ..kernels.dce_comp import ops as dce_ops
from ..kernels.l2_topk import ops as l2_ops
from .sharded import merge_shard_topk

__all__ = ["build_secure_scan_step", "build_secure_scan_step_gspmd",
           "secure_scan_input_specs", "secure_scan_pspecs"]


def secure_scan_input_specs(n: int, d: int, batch: int, *,
                            dtype=torch.float32) -> dict:
    """Shape-and-dtype stand-ins (meta-device tensors, no allocation),
    all four of `dtype`, as the reference's specs make them."""
    Dd = 2 * d + 16
    return {
        "C_sap": torch.empty((n, d), dtype=dtype, device="meta"),
        "C_dce": torch.empty((n, 4, Dd), dtype=dtype, device="meta"),
        "Q_sap": torch.empty((batch, d), dtype=dtype, device="meta"),
        "T_q": torch.empty((batch, Dd), dtype=dtype, device="meta"),
    }


def secure_scan_pspecs(devices) -> dict:
    """For each input, the dimension it is split along over `devices`
    (None: replicated — the queries are tiny)."""
    return {"C_sap": 0, "C_dce": 0, "Q_sap": None, "T_q": None}


def _blocks(C_sap, devices) -> list[torch.Tensor]:
    """The per-shard row blocks of C_sap on their devices: C_sap is one
    (n, d) tensor (split into len(devices) equal row blocks, views where
    a block's device is C_sap's) or already a list of blocks."""
    if isinstance(C_sap, (list, tuple)):
        return [b.to(dev) for b, dev in zip(C_sap, devices)]
    S = len(devices)
    n = C_sap.shape[0]
    if n % S:
        raise ValueError(f"{n} rows do not split into {S} equal shards")
    per = n // S
    return [C_sap[s * per:(s + 1) * per].to(devices[s]) for s in range(S)]


def build_secure_scan_step_gspmd(devices, *, k: int, k_prime: int):
    """The global formulation: one fused scan over all rows (on the
    refine device) and the fused refine.  step(C_sap, C_dce, Q_sap, T_q,
    with_candidates=False) -> ids (B, k) [, candidates (B, k')]."""

    def step(C_sap, C_dce, Q_sap, T_q, with_candidates: bool = False):
        home = C_dce.device
        if isinstance(C_sap, (list, tuple)):
            C_sap = torch.cat([b.to(home) for b in C_sap])
        _, cand = l2_ops.knn(Q_sap.to(home), C_sap, k_prime)
        ids = dce_ops.refine_topk(C_dce, cand, T_q.to(home), None, k)
        return (ids, cand) if with_candidates else ids

    return step


def build_secure_scan_step(devices, *, k: int, k_prime: int):
    """The sharded formulation over `devices` (one shard each): K1 per
    shard, the merge, K2.  step(C_sap, C_dce, Q_sap, T_q,
    with_candidates=False) -> ids (B, k) [, candidates (B, k')];
    C_sap is the (n, d) tensor or its per-shard blocks, C_dce lies on
    the device that refines."""
    devices = list(devices)

    def step(C_sap, C_dce, Q_sap, T_q, with_candidates: bool = False):
        home = C_dce.device
        blocks = _blocks(C_sap, devices)
        per = blocks[0].shape[0]
        kp = min(k_prime, per)
        queries = {dev: Q_sap.to(dev) for dev in dict.fromkeys(devices)}
        parts = [(s * per, *l2_ops.knn(queries[dev], blk, kp))
                 for s, (blk, dev) in enumerate(zip(blocks, devices))]
        width = min(k_prime, per * len(blocks))
        cand = merge_shard_topk(parts, width, Q_sap.shape[0], home)
        ids = dce_ops.refine_topk(C_dce, cand, T_q.to(home), None, k)
        return (ids, cand) if with_candidates else ids

    return step
