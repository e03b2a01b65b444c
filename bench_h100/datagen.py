"""The benchmark's inputs, made from --seed: the base set, the query pool
and the order of the batches.

The data is a torch copy of the program's clustered-Gaussian stand-in
(`data/synth.py`: centers N(0, 1) * center_scale, one center drawn per
row, plus N(0, std^2) noise), drawn on the device with one
`torch.Generator` in a few large calls.  The queries come from the same
mixture.  Both sides of a run get the same arrays: the program as its
users would send them, the reference to work the answers out again.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SEED_NAMES", "seeds", "mixture", "batches"]

SEED_NAMES = ("data", "owner_keys", "owner_noise", "user_sap", "user_trap")


def seeds(seed: int) -> dict[str, int]:
    """One sub-seed below 2**31 for each use, from numpy's SeedSequence:
    any whole number, of any size, gives the same set each time."""
    state = np.random.SeedSequence(int(seed)).generate_state(
        len(SEED_NAMES), dtype=np.uint32)
    return {name: int(s) >> 1 for name, s in zip(SEED_NAMES, state)}


def mixture(cfg: dict, n_queries: int, seed: int,
            device) -> tuple[torch.Tensor, torch.Tensor]:
    """(base (n, d), queries (n_queries, d)) float32 on `device`."""
    data = cfg["data"]
    if data["kind"] != "clustered_gaussian":
        raise ValueError(f"unknown data kind {data['kind']!r}")
    n, d, c = int(cfg["n"]), int(cfg["d"]), int(data["clusters"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    centers = torch.randn((c, d), generator=gen, device=device) \
        * float(data["center_scale"])

    def draw(rows: int) -> torch.Tensor:
        pick = torch.randint(0, c, (rows,), generator=gen, device=device)
        out = torch.randn((rows, d), generator=gen, device=device)
        return out.mul_(float(data["std"])).add_(centers[pick])

    return draw(n), draw(int(n_queries))


def batches(traffic: dict) -> list[slice]:
    """The pool cut into the mix's batches, in the order a client sends
    them; the window goes round them as often as it lasts."""
    pool, b = int(traffic["pool"]), int(traffic["batch"])
    if pool % b:
        raise ValueError(f"pool {pool} is not a whole number of batches "
                         f"of {b}")
    return [slice(s, s + b) for s in range(0, pool, b)]
