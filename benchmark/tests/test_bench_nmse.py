"""The frozen work count of the score's NMSE reduction: H read once and the
estimate's distinct values once, whatever view the estimator returns."""
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.work import nmse, peaks  # noqa: E402


def test_nmse_counts():
    """The port's count on the estimators' broadcast views agrees."""
    from ce5g_torch.ops import nmse as nmse_mod

    b, s, r, t, k = 2, 3, 4, 5, 7
    nbytes, flops = nmse.work(b, s, r, t, k)
    assert nbytes == 8 * b * s * r * t * k + 8 * b * s * r * k
    assert flops == 10 * b * s * r * t * k
    h = torch.zeros(b, s, r, t, k, dtype=torch.complex64)
    ls = torch.zeros(b, r, s, k, dtype=torch.complex64).transpose(1, 2)
    mmse = torch.zeros(b, s, r, k, dtype=torch.complex64)
    for e in (ls, mmse):
        assert nmse_mod.work(h, e[:, :, :, None, :].expand(b, s, r, t, k)) == (nbytes, flops)
    # the 100 MHz carrier at 64 antennas: 7.51 GB, 2.24 ms at 3.35 TB/s
    big, _ = nmse.work(64, 14, 64, 4, 3275)
    assert round(big / 1e9, 2) == 7.51
    assert peaks.least_seconds(big, {"fp32": nmse.work(64, 14, 64, 4, 3275)[1]},
                               peaks.peaks_for("NVIDIA H100 80GB HBM3")) == pytest.approx(
        big / 3.35e12)
