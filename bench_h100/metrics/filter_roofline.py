"""filter_roofline: the filter's share of its roofline, in percent: the
least time of its work (the configuration's `layers.filter.work`) over
the device time the kernel profiler gave its entry points."""

from bench_h100 import roofline


def read(ctx):
    return roofline.share(ctx, "filter")
