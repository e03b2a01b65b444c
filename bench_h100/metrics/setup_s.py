"""setup_s: from the start of the benchmark's process to the first timed
batch."""


def read(ctx):
    return ctx.setup["setup_s"]
