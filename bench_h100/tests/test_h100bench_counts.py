"""The work counts and peaks against values computed by hand for the
three cells (B 1024, n 1,000,000, d 128, D 272), and against the bounds
the program's chip_smoke.py printed for the kernel table."""

import pytest

from bench_h100 import peaks, spec

SHAPE = {"nq": 1024, "n": 1_000_000, "d": 128}


@pytest.mark.parametrize("work,kp,k,ops,nbytes,bound_s", [
    # K1: 2*1024*1e6*128 + 2*(1024+1e6)*128 + 3*1024*1e6 operations;
    # 4*1024*128 + 4*1e6*128 + 12*1024*k' bytes; bound by the fp32 peak
    ("fp32_scan", 80, 10, 265_472_262_144, 513_507_328,
     265_472_262_144 / 67e12),
    ("fp32_scan", 800, 100, 265_472_262_144, 522_354_688,
     265_472_262_144 / 67e12),
    # K4: 2*1024*1e6*128 int8 operations; 1024*128 + 1e6*128 + 5e6 +
    # 12*1024*160 bytes; bound by the int8 peak
    ("sq8_scan", 160, 10, 262_144_000_000, 135_097_152,
     262_144_000_000 / 1979e12),
    # K2: 4*1024*k'^2*272 + 2*1024*k'*272 + 1024*k'^2 operations;
    # 16*1024*k'*272 + 4*1024*272 + 9*1024*k' + 8*1024*k bytes
    ("dce_refine", 80, 10, 7_181_434_880, 358_449_152,
     7_181_434_880 / 67e12),
    ("dce_refine", 160, 10, 28_636_610_560, 715_702_272,
     28_636_610_560 / 67e12),
    ("dce_refine", 800, 100, 714_132_684_800, 3_574_464_512,
     714_132_684_800 / 67e12),
])
def test_cell_counts(work, kp, k, ops, nbytes, bound_s):
    got = spec.part("work", work).count(**SHAPE, kp=kp, k=k)
    assert got["ops"] == ops and got["bytes"] == nbytes
    assert peaks.bound_s(got["ops"], got["bytes"], got["peak"]) == \
        pytest.approx(bound_s, rel=1e-12)


@pytest.mark.parametrize("work,shape,bound_ms", [
    # chip_smoke's K1 row (nq 32, n 1M, d 128, k' 80): 0.1528 ms (bytes)
    ("fp32_scan", {"nq": 32, "n": 1_000_000, "d": 128, "kp": 80, "k": 10},
     0.1528),
    # chip_smoke's K2 row (B 32, n 80, D 272): 0.00335 ms (operations)
    ("dce_refine", {"nq": 32, "n": 80, "d": 128, "kp": 80, "k": 10},
     0.00335),
])
def test_chip_smoke_bounds(work, shape, bound_ms):
    got = spec.part("work", work).count(**shape)
    ms = peaks.bound_s(got["ops"], got["bytes"], got["peak"]) * 1e3
    assert ms == pytest.approx(bound_ms, rel=2e-3)


def test_peaks_are_the_roofline_modules():
    assert peaks.PEAK_OPS["fp32"] == 67e12
    assert peaks.PEAK_OPS["int8"] == 1979e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12
