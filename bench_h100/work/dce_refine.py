"""Work of the DCE tournament refine (K2, `dce_comp.refine_topk`): for
each query the Z matrix of its k' candidates, two products over D =
2d + 16 (4 k'^2 D operations), the win counts and the top-k; each
candidate's four ciphertext rows and the trapdoor read once.  The counts
of the program's chip_smoke.py."""


def count(nq: int, d: int, kp: int, k: int, **_) -> dict:
    D = 2 * (d + d % 2) + 16
    return {"ops": 4.0 * nq * kp * kp * D + 2.0 * nq * kp * D + nq * kp * kp,
            "bytes": 4.0 * nq * kp * 4 * D + 4.0 * nq * D + 9.0 * nq * kp
            + 8.0 * nq * k,
            "peak": "fp32"}
