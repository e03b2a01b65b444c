"""Gradient compression: int8 ring all-reduce with f32 accumulation, the
counterpart of `repro.sharding.compression`.

The reference writes the ring in `shard_map` with `jax.lax.ppermute`;
here the ring runs over a list of per-device tensors (one a logical
device of `launch.mesh`), and a ppermute hop is a `.to(next device)`
copy of each rank's int8 payload and its f32 scale.  The hop order, the
chunking and every rounding are the reference's, so rank r of the list
ends with what rank r of the reference's mapped axis ends with.
Nothing here starts a process: the reference's ring runs inside one
program too.

    sync = make_int8_allreduce(mesh, axis="data")
    grads = sync(grads)        # each leaf a list, one tensor a device
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["quantize_int8", "dequantize_int8", "int8_ring_allreduce",
           "make_int8_allreduce"]


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8; returns (q int8, scale f32 0-d).

    The scale is amax divided by 127 in a true float32 division, as the
    reference's ring computes it.  The divisor is a tensor on x's
    device: CUDA divides by a host scalar as a product with its
    reciprocal, whose extra rounding moves the scale by an ulp now and
    then, and with it the rounding of a few values."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / torch.tensor(127.0, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _hop(payload: list, devices: list) -> list:
    """ppermute i -> i + 1: rank r receives rank r - 1's (q, scale)."""
    n = len(payload)
    return [(payload[r - 1][0].to(devices[r]),
             payload[r - 1][1].to(devices[r])) for r in range(n)]


def int8_ring_allreduce(xs: list) -> list:
    """Ring all-reduce of one tensor a rank, whose hops carry int8 (+1
    f32 scale): a reduce-scatter of n-1 hops, each sending an int8
    partial to the next rank and accumulating in f32, then an
    all-gather of n-1 hops circulating the reduced int8 chunks.
    -> one tensor a rank, each on its rank's device."""
    n = len(xs)
    if n == 1:
        return list(xs)
    shape, dtype = xs[0].shape, xs[0].dtype
    devices = [x.device for x in xs]
    numel = xs[0].numel()
    pad = (-numel) % n
    chunks = [F.pad(x.float().reshape(-1), (0, pad)).reshape(n, -1)
              for x in xs]                                # chunk c a rank

    # ---- reduce-scatter: rank r starts with its copy of chunk (r+1) and
    # at hop s receives the partial for chunk (r-s+1), adding its own copy;
    # after n-1 hops it holds the full sum of chunk (r+2-n) mod n.
    acc = [chunks[r][(r + 1) % n] for r in range(n)]
    for step in range(1, n):
        recv = _hop([quantize_int8(a) for a in acc], devices)
        acc = [dequantize_int8(*recv[r]) + chunks[r][(r - step + 1) % n]
               for r in range(n)]

    # ---- all-gather: circulate the reduced chunks n-1 hops (int8 wire)
    out = [torch.zeros_like(c) for c in chunks]
    cur = [(r + 2 - n) % n for r in range(n)]             # chunk r owns
    wire = [quantize_int8(a) for a in acc]
    for r in range(n):
        out[r][cur[r]] = dequantize_int8(*wire[r])
    for _ in range(n - 1):
        wire = _hop(wire, devices)
        cur = [(c - 1) % n for c in cur]
        for r in range(n):
            out[r][cur[r]] = dequantize_int8(*wire[r])
    return [o.reshape(-1)[:numel].reshape(shape).to(dtype) for o in out]


def make_int8_allreduce(mesh, axis: str = "data"):
    """A tree all-reduce over `axis` of `mesh` with the int8 wire: each
    leaf of the (nested dict) tree is a list of one tensor a device
    along the axis."""
    n = mesh.shape[axis]

    def sync_tree(tree):
        if isinstance(tree, dict):
            return {k: sync_tree(v) for k, v in tree.items()}
        if len(tree) != n:
            raise ValueError(f"{len(tree)} tensors for a {axis!r} axis of "
                             f"{n} devices")
        return int8_ring_allreduce(tree)

    return sync_tree
