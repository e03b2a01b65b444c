"""Work of an exhaustive float32 scan with a running top-k' (K1,
`l2_topk.knn`): ||q||^2 - 2 q.x + ||x||^2 for every query and row, each
input read once, k' (distance, id) pairs a query written.  The counts of
the program's chip_smoke.py."""


def count(nq: int, n: int, d: int, kp: int, **_) -> dict:
    return {"ops": 2.0 * nq * n * d + 2.0 * (nq + n) * d + 3.0 * nq * n,
            "bytes": 4.0 * nq * d + 4.0 * n * d + 12.0 * nq * kp,
            "peak": "fp32"}
