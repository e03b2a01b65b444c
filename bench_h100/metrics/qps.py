"""qps: queries answered in the window over the window's seconds."""


def read(ctx):
    return ctx.counters["n_queries"] / ctx.window["seconds"]
