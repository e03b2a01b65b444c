"""device_bytes_per_vector: the card's peak allocated bytes over the
window (torch.cuda.max_memory_allocated, reset at its start) per base
vector."""


def read(ctx):
    peak = ctx.window["memory_peak"]
    return peak / ctx.shape["n"] if peak else None
