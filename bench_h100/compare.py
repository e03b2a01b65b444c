"""The comparison that decides `correct`: every answer the window
returned against the reference's answer to the same query.

Three numbers; a cell compares those its `limits/<cell>.json` names:

  foreign_share      the share of answer slots holding an id that is not
                     among the reference filter's k' candidates for that
                     query: an id no sound filter could have passed on
                     (a wrong row, another query's answer, a stale one);
  missing_share      the share of the reference's ids that the answer
                     lacks, at any rank: the set;
  id_mismatch_share  the share of answer slots (query, rank) whose id is
                     not the reference's id at that rank: the set and the
                     order.

The float32 DCE ciphertexts flip comparisons of candidates whose true
distances lie within ~3e-4 of each other (a float64 evaluation of the
same ciphertexts flips them too), and win counts shift the ranks behind
a flip, so sound runs read the last two above zero.  The first reads
zero unless the filter's k'-th candidate ties to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NUMBERS", "measure", "judge", "gaps"]

NUMBERS = ("foreign_share", "missing_share", "id_mismatch_share")
_ROWS = 4096


def measure(got: np.ndarray, rows: np.ndarray, want: np.ndarray,
            cand: np.ndarray) -> dict[str, float]:
    """got (N, k) int64 the answers, rows (N,) the pool row each answers;
    want (pool, k) the reference's answers, cand (pool, k') its filter's
    candidates."""
    if got.shape[1] != want.shape[1] or got.shape[0] != rows.shape[0]:
        raise ValueError(f"answers {got.shape} for {rows.shape[0]} rows, "
                         f"reference {want.shape}")
    want_t = torch.from_numpy(want)
    allowed = torch.sort(torch.from_numpy(cand), dim=1).values
    foreign = mismatched = missing = 0
    for s in range(0, got.shape[0], _ROWS):
        g = torch.from_numpy(got[s:s + _ROWS])
        r = torch.from_numpy(rows[s:s + _ROWS])
        w, a = want_t[r], allowed[r]
        pos = torch.searchsorted(a, g).clamp_(max=a.shape[1] - 1)
        foreign += int((torch.gather(a, 1, pos) != g).sum())
        mismatched += int((g != w).sum())
        missing += int((~(w[:, :, None] == g[:, None, :]).any(-1)).sum())
    slots = got.size
    return {"foreign_share": foreign / slots,
            "missing_share": missing / slots,
            "id_mismatch_share": mismatched / slots}


def judge(values: dict[str, float], limits: dict) -> dict[str, dict]:
    """{number: {"value", "limit"}} for each number the cell's limits
    name: a cell compares the numbers that separate its sound runs from
    its control."""
    return {name: {"value": values[name], "limit": float(limits[name])}
            for name in NUMBERS if name in limits}


def gaps(got: np.ndarray, want: np.ndarray, P: np.ndarray,
         Q: np.ndarray) -> dict[str, float]:
    """Where the answers differ, how far apart the two ids' true
    distances lie, relative to the reference's: flipped near-ties read
    ~1e-4 at the median (ranks shifted behind a flip read more), a
    wrong row of order 1.  Q holds each row's plaintext query.
    Reported beside the checks, not compared."""
    r, c = np.nonzero(got != want)
    if r.size == 0:
        return {"slots": 0}
    q = Q[r].astype(np.float64)
    dg = ((P[np.clip(got[r, c], 0, None)] - q) ** 2).sum(1)
    dw = ((P[want[r, c]] - q) ** 2).sum(1)
    rel = np.abs(dg - dw) / dw
    return {"slots": int(r.size), "median": float(np.median(rel)),
            "p99": float(np.percentile(rel, 99)), "max": float(rel.max())}
