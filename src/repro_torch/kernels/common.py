"""Shared helpers for the hand-written CUDA kernels and their wrappers.

Mirrors `repro.kernels.common`.  The dispatch rule replaces the JAX
package's `interpret_default()`: a wrapper launches its CUDA kernel for
CUDA tensors and runs its plain PyTorch version for CPU tensors, and
nothing else (no fallback from a failed launch to the plain version).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs.profiler import active_profiler

__all__ = ["next_bucket", "running_topk_scan", "top_positions", "pad_to",
           "padded_size", "on_cpu", "on_meta", "pass_sizes", "floor_passes",
           "ROW_DTYPES", "row_operand", "float_operand", "int_operand",
           "BlockPlan", "block_plan", "count_plan"]

# The element types the float kernels read in place, and the code their C
# entries take for each (csrc: 0 float, 1 __nv_bfloat16, 2 __half).  The
# Pallas kernels cast any float operand to float32 before they compute;
# bf16 and f16 values are exact in float32, so a kernel converts them in
# registers or shared memory and does the same fp32 arithmetic.
ROW_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def row_operand(x: torch.Tensor, what: str) -> tuple[torch.Tensor, int]:
    """A kernel's large operand (a corpus of rows) as it reads it:
    float32, bfloat16 or float16 in place, with its element code; float64
    rounded to float32, as the reference's `astype` rounds it.  Any other
    dtype raises TypeError."""
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    if x.dtype not in ROW_DTYPES:
        raise TypeError(f"{what} takes a float32, bfloat16, float16 or "
                        f"float64 operand, got {x.dtype}")
    return x, ROW_DTYPES[x.dtype]


def float_operand(x: torch.Tensor, what: str) -> torch.Tensor:
    """A kernel's small float operand (queries, trapdoors, tables) as
    float32: the reference's `astype(float32)`.  Non-float dtypes raise
    TypeError."""
    if not x.dtype.is_floating_point:
        raise TypeError(f"{what} takes a float operand, got {x.dtype}")
    return x.to(torch.float32)


def int_operand(x: torch.Tensor, what: str) -> torch.Tensor:
    """A kernel's small integer operand as int32: the reference's
    `astype(int32)`.  Float and bool dtypes raise TypeError."""
    if x.dtype.is_floating_point or x.dtype.is_complex or \
            x.dtype == torch.bool:
        raise TypeError(f"{what} takes an integer operand, got {x.dtype}")
    return x.to(torch.int32)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True iff every tensor lies on the host: the only case in which a
    wrapper runs its plain version.  Mixed placements raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors on mixed devices: "
                     f"{[str(t.device) for t in tensors]}")


def on_meta(*tensors: torch.Tensor) -> bool:
    """True iff every tensor is a `meta` tensor (shape and dtype, no
    storage: the dry run's stand-ins), for which a wrapper makes its
    kernel's outputs and device buffers, of the shapes the card would
    allocate, and launches nothing."""
    return all(t.device.type == "meta" for t in tensors)


def next_bucket(n: int, minimum: int = 1, maximum: int | None = None) -> int:
    """Smallest power-of-two bucket >= max(n, minimum), optionally capped.

    Callers that see ragged sizes (owner-side encryption batches) pad to
    bucketed shapes; the owner's DCE randomization scale is taken over
    the whole padded batch, so the bucket rule is part of the
    ciphertext distribution, not only a cache key.
    """
    if n < 0:
        raise ValueError(f"negative size {n}")
    b = max(minimum, 1)
    while b < n:
        b <<= 1
    if maximum is not None and b > maximum:
        if n > maximum:
            raise ValueError(f"size {n} exceeds bucket cap {maximum}")
        b = maximum
    return b


def running_topk_scan(dist_fn, n: int, nq: int, k: int, chunk: int,
                      device: torch.device, *, dtype=torch.float32,
                      fill=float("inf")):
    """Streaming top-k merge: fold `chunk`-row distance blocks into a
    running (nq, k) ascending state of `dtype`, first filled with `fill`.

    `dist_fn(start)` returns the (nq, chunk) distance block for rows
    [start, start+chunk), with rows past the database already `fill`.
    Ties go to the lowest id, as `jax.lax.top_k` keeps them: the merge
    is a stable ascending sort of [best, block], in which running
    entries precede the block and block columns keep their order.
    Merge positions < k select from the running ids, the rest are
    `start + (pos - k)`, so no (nq, chunk) id block is materialized.
    Returns (dists (nq, k) ascending, ids (nq, k) int64; unfilled -1).
    An integer state (int32 with a sentinel fill) keeps integer
    distances exact where float32 would round those above 2^24.
    """
    best_d = torch.full((nq, k), fill, dtype=dtype, device=device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=device)
    for start in range(0, n, chunk):
        d_blk = dist_fn(start)
        cat_d = torch.cat([best_d, d_blk], dim=1)
        vals, pos = torch.sort(cat_d, dim=1, stable=True)
        best_d, pos = vals[:, :k], pos[:, :k]
        from_best = torch.gather(best_i, 1, pos.clamp(max=k - 1))
        best_i = torch.where(pos < k, from_best, start + (pos - k))
    return best_d, best_i


def top_positions(d: torch.Tensor, kp: int) -> torch.Tensor:
    """Positions of the kp smallest entries of each row of d, ascending,
    ties to the lowest position: what `lax.top_k(-d, kp)` gives."""
    return torch.sort(d, dim=1, stable=True).indices[:, :min(kp, d.shape[1])]


def pad_to(x: torch.Tensor, axis: int, multiple: int,
           value: float = 0.0) -> torch.Tensor:
    """Right-pad `axis` of x up to a multiple."""
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def padded_size(n: int, multiple: int) -> int:
    return n + ((-n) % multiple)


def pass_sizes(k: int, most: int) -> list[int]:
    """k slots as ceil(k / most) passes of near-equal size, the larger
    first; above `most`, every pass takes at least most / 2."""
    p = -(-k // most)
    return [k // p + (i < k % p) for i in range(p)]


def floor_passes(k: int, most: int, nq: int, one_pass, fill, device):
    """The first k keys of each query from a fused scan + top-k kernel
    that keeps at most `most`: one pass where k <= most, else passes of
    `pass_sizes(k, most)`, each offering only the keys after its query's
    floor key, the last key of the pass before.  `one_pass(kp, floor_in,
    floor_out)` runs one pass: it reads floor_in ((nq,) int64 key bits;
    None on the first pass) and leaves its own last keys in floor_out;
    it returns (dists (nq, kp), ids (nq, kp)), ids -1 where the valid
    rows ran out.  The passes stop
    when every query ran out, and the rest is (fill, -1).  Each pass
    computes the same distances and keys, so the joined lists are the
    first k keys in the stable sort's order.  -> (dists (nq, k), ids)."""
    if k <= most:
        return one_pass(k, None, None)
    sizes = pass_sizes(k, most)
    floor = torch.empty(nq, dtype=torch.int64, device=device)
    dists, ids = [], []
    for i, kp in enumerate(sizes):
        d, idx = one_pass(kp, floor if i else None, floor)
        dists.append(d)
        ids.append(idx)
        left = sum(sizes[i + 1:])
        if left and not bool((idx[:, -1] >= 0).any()):
            dists.append(torch.full((nq, left), fill, dtype=d.dtype,
                                    device=device))
            ids.append(torch.full((nq, left), -1, dtype=idx.dtype,
                                  device=device))
            break
    return torch.cat(dists, 1), torch.cat(ids, 1)


class BlockPlan(NamedTuple):
    """How a fused scan + top-k' call lays its query groups x row tiles
    onto the card: the rows cut into G chunks of chunk_rows (whole tiles),
    one block per (query group, chunk).  work_tiles (groups x tiles) and
    slot_tiles (slots x waves x tiles a chunk) are the tiles scanned and
    the block time the card holds for them: their ratio is its fill."""
    chunk_rows: int
    G: int
    work_tiles: int
    slot_tiles: int


def block_plan(groups: int, n: int, tile: int, slots: int,
               chunk_cost: float) -> BlockPlan:
    """The plan of least makespan for `groups` query groups over n rows in
    tiles of `tile` rows, `slots` blocks at once (the SMs x the blocks of
    the launched variant resident on one).  G chunks take ceil(groups G /
    slots) waves of ceil(tiles / G) + chunk_cost tile-times (chunk_cost: a
    chunk's fixed cost -- its first tile, whose keys are all offered, the
    ring's fill, one more list to merge -- in tile-times).  Ties go to the
    smaller G, fewer lists to merge.  Only the least G of each chunk
    length is tried: a larger one adds blocks and no tile a chunk."""
    tiles = -(-n // tile)
    best = None
    G = 1
    while True:
        per = -(-tiles // G)
        waves = -(-groups * G // slots)
        cost = waves * (per + chunk_cost)
        if best is None or cost < best[0]:
            best = (cost, per, G, waves)
        if per == 1:
            break
        G = (tiles - 1) // (per - 1) + 1
    _, per, G, waves = best
    return BlockPlan(per * tile, G, groups * tiles, slots * waves * per)


def count_plan(kernel: str, plan: BlockPlan) -> None:
    """Add a launch's work and slot tiles to the active kernel profiler's
    counters under `kernel`; nothing while none is active."""
    prof = active_profiler()
    if prof is not None:
        prof.count(kernel, work_tiles=plan.work_tiles,
                   slot_tiles=plan.slot_tiles)
