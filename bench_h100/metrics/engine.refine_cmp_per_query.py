"""engine.refine_cmp_per_query: the program's count of DCE comparisons
(SearchStats.refine_comparisons) over the queries it answered in the
window."""


def read(ctx):
    q = ctx.counters["n_queries"]
    return ctx.counters["refine_comparisons"] / q if q else None
