"""batch_p95_ms: the 95th percentile, in ms, of the window's batch times
(host clock, from the call with numpy ciphertexts to the ids on the
host), over every batch of the window."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.window["latency_s"], 95)) * 1e3
