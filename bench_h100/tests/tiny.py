"""A cell cut to a size the host runs in a second: 4,096 rows of width
32, a pool of 128 queries in batches of 32.  The widths of the program's
cards are not at stake here: the tests check the harness's logic."""

from bench_h100 import harness

CELLS = ("sift1m-flat.b1024-k10", "sift1m-int8.b1024-k10",
         "sift1m-flat.b1024-k100")
SEED = 2 ** 33 + 7            # above 32 bits, as the driver's seeds are


def cell(name: str, trace: bool = False, n: int = 4096, d: int = 32,
         batch: int = 32, pool: int = 128) -> harness.Cell:
    c = harness.Cell.load(name, trace)
    c.cfg = dict(c.cfg, n=n, d=d)
    c.traffic = dict(c.traffic, batch=batch, pool=pool)
    return c
