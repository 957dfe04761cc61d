"""The frozen work counts, on hand-counted small cases, and the step count's
independence from the kernel routes the port's ``plan()`` picks."""
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.reference.carrier import Carrier  # noqa: E402
from benchmark.work import hpd_solve, interp, interp_fused, peaks, step  # noqa: E402


def test_hpd_solve_counts():
    # (2, 3, 3) systems with 2 right-hand sides: A 9 + B 6 + X 6 complex64 values a system
    nbytes, flops = hpd_solve.work(2, 3, 2)
    assert nbytes == 8 * 2 * (9 + 6 + 6)
    assert flops == 8 * 2 * (27 / 6 + 9 * 2)


def test_interp_counts():
    # one frame, R = 2, P = 4 slots of which 3 valid, a 2 x 3 grid
    nbytes, flops = interp.work(1, 2, 4, 2, 3, [3], "cubic")
    assert nbytes == 8 * 2 * 4 + 8 * 4 + 4 * 4 + 8 * 2 * 6
    assert flops == (9 + 4 * 2) * 6 * 3
    _, flops = interp.work(1, 2, 4, 2, 3, [3], "linear")
    assert flops == (4 + 3) * 6 * 3 + (1 + 4 * 2) * 6 * 3
    _, flops = interp.work(1, 2, 4, 2, 3, [3], "nearest")
    assert flops == (4 + 1) * 6 * 3 + (1 + 4 * 2) * 6 * 1
    # more pilots than the 128-candidate window: each point scores 128
    _, flops = interp.work(1, 1, 300, 1, 1, [300], "cubic")
    assert flops == (9 + 4) * 128


def test_interp_fused_counts():
    # one frame, one symbol, pilots at columns 0 and 3 of 4: 'nearest' puts
    # weight on one pilot at columns 0, 3 and on both at the tie 1.5 ... not
    # on the grid, so each column selects exactly its nearest
    mask = torch.tensor([[[1.0, 0.0, 0.0, 1.0]]])
    nbytes, flops = interp_fused.work(mask, 2, "nearest")
    assert nbytes == 4 * 4 + 2 * 8 * 2 * 4
    # candidates: 2 sides x 1 row; selected: one a column at 0, 1, 2, 3
    assert flops == 5 * 1 * 2 * 4 + 4 * 2 * 4


def test_peaks_hold_float64():
    p = peaks.peaks_for("NVIDIA H100 80GB HBM3")
    assert p["fp64_flops"] == 67e12 and p["fp32_flops"] == 67e12 and p["hbm_Bps"] == 3.35e12
    assert peaks.peaks_for("some other card") is None
    assert peaks.least_seconds(3.35e12, {"fp32": 67e12, "fp64": 67e12}, p) == pytest.approx(2.0)


def _carrier(r):
    return Carrier(fft_size=64, cp_length=8, num_symbols=4, useful_subcarriers=20,
                   subcarrier_spacing=15000.0, num_tx=2, num_rx=r, num_oscillators=3,
                   tap_collision="overwrite", max_density=0.15)


def test_step_bytes_by_hand():
    c = _carrier(2)  # S 4, K 19, R 2, T 2, O 3, P_max int(76 · 0.15) = 11
    w = step.work(c, "mmse_full", "linear", 2, [9], [7])
    s, k, r, t, o = 4, 19, 2, 2, 3
    draws = 4 * s * k * 2 + 2 * 4 * 9 * r * t * o + 2 * 4 * s * r * k
    frame = 8 * s * k + 8 * s * r * k + 8 * s * r * t * k + 4 * s * k + 8 * 11 + 4 * 11 + 4
    assert w["bytes"] == draws + frame + 8 * s * r * k + 8 * s * r * t * k + 8 * s * r * k
    assert w["fp64"] > 0 and w["fp32"] > 0


@pytest.mark.parametrize("estimator,method", [("mmse_full", "linear"), ("ls", "cubic"),
                                              ("ls", "linear")])
def test_step_count_ignores_the_kernel_routes(monkeypatch, estimator, method):
    """The step's count is the same whichever route the port's plans pick:
    it reads shapes and pilots, never a plan."""
    from ce5g_torch.ops import hpd_solve as hpd_mod
    from ce5g_torch.ops import interp as slot_mod
    from ce5g_torch.ops import interp_fused as grid_mod

    c = _carrier(64)
    mask = torch.zeros(2, 4, 19)
    mask[:, ::2, ::3] = 1.0
    n = [int(mask[0].sum())] * 2
    before = step.work(c, estimator, method, 3, [9, 9], n, mask)
    monkeypatch.setattr(hpd_mod, "plan", lambda n, r: hpd_mod.Plan("blocked"))
    monkeypatch.setattr(slot_mod, "plan", lambda r, p, s, k: slot_mod._plan(r, p, s, k, "tile"))
    monkeypatch.setattr(grid_mod, "plan", lambda r, s, k: grid_mod._plan(r, s, k, "global"))
    assert step.work(c, estimator, method, 3, [9, 9], n, mask) == before
    # and the same for a receiver the port's plans take by other routes
    assert step.work(_carrier(4), estimator, method, 3, [9, 9], n, mask)["bytes"] < before["bytes"]


def test_step_counts_the_interpolation_work():
    c = _carrier(2)
    mask = torch.zeros(1, 4, 19)
    mask[0, 1, 5] = mask[0, 2, 11] = 1.0
    grid = step.work(c, "ls", "linear", None, [9], [2], mask)["fp32"]
    slot = step.work(c, "ls", "cubic", None, [9], [2], mask)["fp32"]
    base = step.work(c, "mmse_full", "linear", 2, [9], [2])["fp32"]
    assert grid - interp_fused.work(mask, 2, "linear")[1] == \
        slot - interp.work(1, 2, 11, 4, 19, [2], "cubic")[1]
    assert base > 0
