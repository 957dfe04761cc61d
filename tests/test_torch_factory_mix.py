"""The dataset factory's per-frame mix (``factory_2x2.mmse_full_mix``) on the
CPU: ``simulate_batch`` → ``estimate_batch(estimator="mmse_full")`` → the
score, held to the benchmark's plain float64 reference
(``benchmark/reference``, which imports neither JAX nor the port) on one
batch whose frames each carry their own profile, Doppler, SNR and pilot
density, at the published 14 × 599 grid and 2 × 2 antennas.

The random numbers are the benchmark's seeded draws (``harness.draws``);
the frames' parameters are set to the cases below, so that every profile,
10 and 200 Hz, −5 and 30 dB and 1% and 10% pilots are held in one batch.
Each case reads its own frame against the cell's limits
(``benchmark/limits/factory_2x2.mmse_full_mix.json``), and the control (the
reference a precision step below the port's, in its place) fails them.
"""
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmark.control import _as_kept  # noqa: E402
from benchmark.harness import check, draws, spec, window  # noqa: E402
from benchmark.harness.program import Program  # noqa: E402
from benchmark.reference import pipeline  # noqa: E402
from benchmark.reference.carrier import Carrier  # noqa: E402
from benchmark.reference.estimators import time_rank  # noqa: E402
from benchmark.reference.precision import CONTROL, REFERENCE  # noqa: E402

CELL = "factory_2x2.mmse_full_mix"
SEED = 2 ** 31 + 2303
PROFILES = ("EPA", "EVA", "ETU")
#: (profile, Doppler Hz, SNR dB, pilot density): one frame each, one batch
CASES = (
    ("EPA", 10.0, 30.0, 0.01),
    ("EPA", 200.0, -5.0, 0.10),
    ("EVA", 10.0, -5.0, 0.01),
    ("EVA", 200.0, 30.0, 0.10),
    ("ETU", 200.0, 30.0, 0.01),
    ("ETU", 10.0, -5.0, 0.10),
    ("ETU", 200.0, 25.0, 0.02),
    ("EVA", 50.0, 30.0, 0.05),
)
#: the port's frames and estimate in float32 against float64, after the
#: Wiener system is assembled in float64 and its float32 solve refined once:
#: rounding of a few float32 ulps of each frame's rms (5e-7 to 9e-7 read
#: here), with room for the card's other reduction orders, and still well
#: under the limits the chip's 25-seed readings set
PORT_ROUNDING = 1e-5


@pytest.fixture(scope="module")
def batch():
    """(cell, the port's, the control's and the reference's outputs) of the
    batch of ``CASES``."""
    cell = spec.Cell(CELL)
    config = {**cell.config, "batch": len(CASES)}
    carrier = Carrier.from_config(config)
    cpu = torch.device("cpu")
    d, _ = draws.Inputs(SEED, len(CASES), carrier, cell.traffic, cpu)(0)
    column = lambda i, dtype=torch.float32: torch.tensor([c[i] for c in CASES], dtype=dtype)  # noqa: E731
    params = pipeline.BatchParams(torch.tensor([PROFILES.index(c[0]) for c in CASES]),
                                  column(1), column(2), column(3), PROFILES)
    rank = time_rank(carrier, config["doppler_hz_configured"])
    program = Program(config, cell.traffic, cpu)
    frames = program.simulate(d, program.frame_params(params))
    h = program.estimate(frames)
    score = program.score(frames, h)
    keep = list(range(len(CASES)))
    run = lambda prec: pipeline.run_batch(d, params, carrier, "mmse_full", "linear", rank,  # noqa: E731
                                          prec, keep=keep, block=4)
    return cell, (frames, h, score), run(CONTROL), run(REFERENCE), carrier.num_tx


def _readings(batch, i, control=False):
    cell, (frames, h, score), ctrl, ref, num_tx = batch
    idx = torch.tensor([i])
    kept = _as_kept(*ctrl, idx, num_tx) if control else window.keep(frames, h, score, idx)
    return cell, check.readings({0: kept}, {0: ref})


def test_the_mix_covers_every_law():
    """Each profile, 10 and 200 Hz, −5 and 30 dB, 1% and 10% pilots."""
    assert {c[0] for c in CASES} == set(PROFILES)
    for i, values in ((1, (10.0, 200.0)), (2, (-5.0, 30.0)), (3, (0.01, 0.10))):
        assert set(values) <= {c[i] for c in CASES}
    traffic = spec.Cell(CELL).traffic
    assert all(c[0] in traffic["profile"] and c[1] in traffic["doppler_hz"]
               and c[2] in traffic["snr_db"] and c[3] in traffic["pilot_density"] for c in CASES)


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(map(str, c)) for c in CASES])
def test_reference_holds_the_port(batch, i):
    cell, values = _readings(batch, i)
    assert values["pattern_mismatches"] == 0  # the pilots are chosen by an exact rule
    for number in ("frames_err", "estimate_err"):
        assert values[number] < PORT_ROUNDING, (number, values)
    ok, lines = check.judge(values, cell.limits, 0)
    assert ok, lines


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(map(str, c)) for c in CASES])
def test_control_is_not_correct(batch, i):
    """The reference in float32 with TF32 matmuls fails the limits on every
    frame of the mix, by both of its errors."""
    cell, values = _readings(batch, i, control=True)
    ok, lines = check.judge(values, cell.limits, 0)
    assert not ok, lines
    assert values["frames_err"] > cell.limits["frames_err"], lines
    assert values["estimate_err"] > cell.limits["estimate_err"], lines
