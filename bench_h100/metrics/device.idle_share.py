"""device.idle_share: the percent of the torch.profiler stretch in which
no operation ran on the card."""


def read(ctx):
    if not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
