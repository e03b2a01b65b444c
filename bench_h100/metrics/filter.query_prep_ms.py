"""filter.query_prep_ms: the host's time building and uploading a
batch's query operand (the program's `filter.query_prep` span: the
float32 ciphertexts, or int8's query codes), in ms per batch, over the
kernel profiler's stretch of a traced run."""

from bench_h100 import spans


def read(ctx):
    prep = spans.per_batch(ctx, "filter.query_prep", "total_s")
    return None if prep is None else 1e3 * prep
