"""The factory's per-frame mix, ``factory_2x2.mmse_full_mix``, on the CPU:
its frames draw their parameters one by one from the traffic's lists; its
time rank is 5 in the reference and the port, so the Wiener system is
n = 9 × 5 = 45 on the HPD solve's register route; one small batch runs
whole and is correct; ``work.profile_gram`` counts by hand at a tiny size;
and ``profile_gram_roofline`` reads the port's ``mmse_full.profiles`` span
and nothing without it."""
import sys
import types
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.harness import draws, port_spans, runner, spec  # noqa: E402
from benchmark.harness.program import experiment_config  # noqa: E402
from benchmark.reference.carrier import Carrier  # noqa: E402
from benchmark.reference.estimators import time_rank  # noqa: E402
from benchmark.work import peaks, profile_gram  # noqa: E402

CELL = "factory_2x2.mmse_full_mix"
SEED = 2 ** 31 + 2311
H100 = "NVIDIA H100 80GB HBM3"


def _raw():
    return spec.Cell(CELL).config


def test_each_frame_draws_its_own_parameters():
    cell = spec.Cell(CELL)
    carrier = Carrier.from_config(cell.config)
    inputs = draws.Inputs(SEED, 512, carrier, cell.traffic, torch.device("cpu"))
    _, params = inputs(0)
    assert inputs.constant is None and params.profiles == ("EPA", "EVA", "ETU")
    assert set(params.profile.tolist()) == {0, 1, 2}
    for got, field in ((params.doppler_hz, "doppler_hz"), (params.snr_db, "snr_db"),
                       (params.density, "pilot_density")):
        assert set(got.tolist()) == {torch.tensor(v).item() for v in cell.traffic[field]}
    _, again = inputs(0)
    assert torch.equal(again.snr_db, params.snr_db)  # batch i is made again from the seed


def test_time_rank_is_5_and_the_solve_takes_the_register_route():
    """The largest configured Doppler, 200 Hz, sets the rank of every frame."""
    from ce5g_torch.estimators.api import auto_time_rank
    from ce5g_torch.ops import hpd_solve

    raw = _raw()
    assert time_rank(Carrier.from_config(raw), raw["doppler_hz_configured"]) == 5
    assert auto_time_rank(experiment_config(raw)) == 5
    assert hpd_solve.plan(9 * 5, raw["num_rx"]).route == "registers"


def test_a_small_batch_is_correct():
    out = runner.run(CELL, SEED, 0.0, False, device="cpu",
                     overrides={"batch": 24, "check_range": 1, "check_batches": 1,
                                "check_frames": 24, "reference_block": 8, "max_batches": 4})
    assert out["correct"], out["check_lines"]


def test_profile_gram_counts():
    # S = 2, R = 1, K = 3; frames of 2 and 1 paths with 3 and 1 pilots
    nbytes, flops = profile_gram.work(2, 1, 3, [2, 1], [3, 1])
    grid = 8 * 1 * 2 * 3 + 4 * 2 * 3  # the LS grid and the mask, a frame
    assert nbytes == 2 * grid + (16 * 2 * 2 + 16 * 2 * 4) + (16 * 2 * 1 + 16 * 2 * 1)
    assert flops == (8 * 3 * 2 + 8 * 3 * 3) + (8 * 1 * 1 + 8 * 1 * 1)


def _ctx(reading, batches):
    """The reader's context: ``batches`` traced batches of (paths, pilots)."""
    carrier = Carrier.from_config(_raw())
    traced = [(types.SimpleNamespace(paths=p),
               types.SimpleNamespace(num_pilots=torch.tensor(n, dtype=torch.int32)))
              for p, n in batches]
    return types.SimpleNamespace(peaks=peaks.peaks_for(H100), carrier=carrier,
                                 traced_inputs=lambda: traced,
                                 frame_paths=lambda params: params.paths, _port_spans=reading)


def _reading(rows, under, batches):
    return port_spans.Reading(batches, rows, 0, 0, 0, 0.0, None, 0.0, 0.0, 0.0, under, {})


def _row(name, calls):
    return port_spans.Row(name, calls, 0.0, 0.0, calls, 0, 0.0)


def test_profile_gram_roofline_reads_the_span():
    reader = spec.Cell(CELL).reader("profile_gram_roofline")
    b = _raw()["batch"]
    mix = [([5, 9] * (b // 2), [83, 838] * (b // 2)), ([9] * b, [419] * b)]
    assert reader.read(_ctx(None, mix)) is None  # no port spans at all
    parent = _reading([_row("mmse_full.gram", 2)], {"mmse_full.gram": 1.2}, 2)
    assert reader.read(_ctx(parent, mix)) is None  # the parent: no profiles span
    reading = _reading([_row("mmse_full.gram", 2), _row("mmse_full.profiles", 2)],
                       {"mmse_full.gram": 1.2, "mmse_full.profiles": 0.8}, 2)
    least = []
    for paths, pilots in mix:
        nbytes, flops = profile_gram.work(14, 2, 599, paths, pilots)
        least.append(max(nbytes / 3.35e12, flops / 67e12))
    assert all(t == pytest.approx(0.114e-3, rel=0.03) for t in least)  # bytes bind: 0.37-0.39 GB
    got = reader.read(_ctx(reading, mix))
    assert got == pytest.approx(100 * 1 * (sum(least) / 2) / 0.8e-3)
    assert 0 < got < 100
