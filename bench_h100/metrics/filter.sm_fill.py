"""filter.sm_fill: how full the fused filter scans keep the card's SMs,
in percent: the tiles their launches scanned (query groups x row tiles)
over the tiles of block time their block plans held (slots x waves x
tiles a chunk), summed over the kernel profiler's stretch of a traced
run.  The program adds both to its kernel profiler's counters table
(`summary().counters`) at each launch; None where the summary has no
such table or no launch added to it."""


def read(ctx):
    table = getattr(ctx.kernels, "counters", None) or {}
    work = sum(c.get("work_tiles", 0) for c in table.values())
    slot = sum(c.get("slot_tiles", 0) for c in table.values())
    return 100.0 * work / slot if slot else None
