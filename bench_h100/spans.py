"""The program's spans as the kernel profiler counts them: while a
`KernelProfiler` is active, each span the engine opens with
`repro_torch.obs.trace.child_span` adds one call, its host seconds and,
on a card, the synchronising CUDA calls made inside it to the span table
that its `summary()` carries as `.spans` (`engine.search_batch`,
`filter.query_prep`, `engine.wait`, ...).  A program without that table
or those spans gives None for every reading here."""

from __future__ import annotations

__all__ = ["BATCH", "per_batch"]

BATCH = "engine.search_batch"           # one span a batched engine call


def per_batch(ctx, name: str, field: str) -> float | None:
    """`field` ("total_s" or "syncs") of the span `name` over the traced
    stretch, per `engine.search_batch` call; None where the stretch has
    no span table, no batch span, no span `name` or no such field."""
    table = getattr(ctx.kernels, "spans", None) or {}
    whole, part = table.get(BATCH), table.get(name)
    if not whole or not whole["calls"] or not part or field not in part:
        return None
    return part[field] / whole["calls"]
