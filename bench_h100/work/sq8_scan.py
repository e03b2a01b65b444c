"""Work of an int8 ADC scan with a running top-k' (K4,
`adc_topk.sq_knn`): q8 . c8 for every query and row on the int8 tensor
cores; the codes, their int32 norms and the validity bytes read once,
k' (surrogate, id) pairs a query written.  The counts of the program's
chip_smoke.py."""


def count(nq: int, n: int, d: int, kp: int, **_) -> dict:
    return {"ops": 2.0 * nq * n * d,
            "bytes": nq * d + n * d + 4.0 * n + n + 12.0 * nq * kp,
            "peak": "int8"}
