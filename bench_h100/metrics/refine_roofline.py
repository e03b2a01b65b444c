"""refine_roofline: the refine's share of its roofline, in percent, as
filter_roofline reads the filter's."""

from bench_h100 import roofline


def read(ctx):
    return roofline.share(ctx, "refine")
