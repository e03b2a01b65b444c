"""engine.syncs_per_batch: the synchronising CUDA calls a batch makes
(blocking copies to and from the card, `.item()` and the like), as
PyTorch's sync check counts them inside the program's
`engine.search_batch` span, per batch, over the kernel profiler's
stretch of a traced run.  None where nothing counted them (no card)."""

from bench_h100 import spans


def read(ctx):
    return spans.per_batch(ctx, spans.BATCH, "syncs")
