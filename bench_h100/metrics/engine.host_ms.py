"""engine.host_ms: the host's own time in a batch, in ms: the program's
`engine.search_batch` span less its `engine.wait` spans (where the host
waits for the card's queued work), per batch, over the kernel profiler's
stretch of a traced run.  The query's upload, whose copy waits on an
idle stream, counts as the host's (`filter.query_prep`)."""

from bench_h100 import spans


def read(ctx):
    whole = spans.per_batch(ctx, spans.BATCH, "total_s")
    wait = spans.per_batch(ctx, "engine.wait", "total_s")
    if whole is None or wait is None:
        return None
    return 1e3 * (whole - wait)
