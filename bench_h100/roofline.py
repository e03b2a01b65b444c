"""A layer's share of its roofline: the least time the card could take
for the layer's work, over the device time the program's kernel
profiler measured for it.

The configuration names, for each layer, the program's entry points that
make it up and the work model (`work/<model>.py`) that counts its
operations and bytes from the cell's shapes.  So the share reads the
work the cell needs, whatever kernel a later change runs for it.
"""

from __future__ import annotations

from . import peaks, spec

__all__ = ["share"]


def share(ctx, layer: str) -> float | None:
    """Percent of the roofline over the batches of the traced stretch,
    or None where the stretch timed no entry of the layer."""
    part = ctx.cfg.get("layers", {}).get(layer)
    if part is None or not ctx.kernels:
        return None
    hits = [ctx.kernels[e] for e in part["entries"] if e in ctx.kernels]
    calls = sum(h["calls"] for h in hits)
    seconds = sum(h["total_s"] for h in hits)
    if calls == 0 or seconds <= 0.0:
        return None
    work = spec.part("work", part["work"]).count(**ctx.shape)
    least = peaks.bound_s(work["ops"], work["bytes"], work["peak"])
    return 100.0 * ctx.kernel_batches * least / seconds
