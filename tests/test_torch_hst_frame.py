"""The whole-frame high-speed-train cell (``nr_frame_hst500_4x4.mmse_full``):
one 10 ms NR frame of 280 × 611 at 30 kHz, 4 × 4 ETU at 1621.5 Hz
(500 km/h at 3.5 GHz), through ``simulate_batch`` →
``estimate_batch(estimator="mmse_full")`` → the score, held to the
benchmark's plain float64 reference (``benchmark/reference``, which imports
neither JAX nor the port) at the published widths.

Both time ranks are 67, so the Wiener system is n = 9 × 67 = 603, past
every cluster instance of the HPD solve: the card takes its ``blocked``
route. On the CPU the port runs the plain solve; the tests marked ``cuda``
hold the blocked kernel on the Wiener systems of the cell's first batch.
"""
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmark.control import _as_kept  # noqa: E402
from benchmark.harness import check, draws, spec, window  # noqa: E402
from benchmark.harness.program import Program, experiment_config  # noqa: E402
from benchmark.reference import pipeline  # noqa: E402
from benchmark.reference.carrier import Carrier  # noqa: E402
from benchmark.reference.estimators import time_rank  # noqa: E402
from benchmark.reference.precision import CONTROL, REFERENCE  # noqa: E402

from ce5g_torch.estimators import mmse as mmse_mod  # noqa: E402
from ce5g_torch.estimators.time_prior import auto_time_rank  # noqa: E402
from ce5g_torch.ops import hpd_solve as hpd_mod  # noqa: E402
from ce5g_torch.utils import profiling  # noqa: E402

CELL = "nr_frame_hst500_4x4.mmse_full"
SEED = 2 ** 31 + 2601
RANK = 67
N = 9 * RANK
#: the port's frames and estimate in float32 against float64: Jakes' float32
#: phases over 10 ms at 1621.5 Hz reach ≈ 100 rad, whose rounding sets
#: frames_err (2.4e-5 read here, 4× the LTE frame's); the Wiener system is
#: assembled in float64 and its float32 solve refined once. Room for the
#: card's other reduction orders, still under the cell's limits
PORT_ROUNDING = 6e-5


def _raw():
    cell = spec.Cell(CELL)
    return cell, cell.config


@pytest.fixture(scope="module")
def frame():
    """(cell, the port's, the control's and the reference's outputs) of
    frame 0 of batch 0, made alone at the published widths."""
    cell, raw = _raw()
    config = {**raw, "batch": 1}
    carrier = Carrier.from_config(config)
    cpu = torch.device("cpu")
    inputs = draws.Inputs(SEED, 1, carrier, cell.traffic, cpu)
    d, params = inputs(0)
    rank = time_rank(carrier, config["doppler_hz_configured"])
    frames, h, score = window.one_batch(Program(config, cell.traffic, cpu), inputs, 0)
    run = lambda prec: pipeline.run_batch(d, params, carrier, "mmse_full", "linear", rank,  # noqa: E731
                                          prec, keep=[0], block=1)
    return cell, window.keep(frames, h, score, torch.arange(1)), run(CONTROL), run(REFERENCE), \
        carrier.num_tx


def test_reference_holds_the_port(frame):
    cell, kept, _, ref, _ = frame
    values = check.readings({0: kept}, {0: ref})
    assert values["pattern_mismatches"] == 0  # the pilots are chosen by an exact rule
    for number in ("frames_err", "estimate_err"):
        assert values[number] < PORT_ROUNDING, (number, values)
    ok, lines = check.judge(values, cell.limits, 0)
    assert ok, lines


def test_control_is_not_correct(frame):
    """The reference in float32 with TF32 matmuls fails the limits by both
    of its errors."""
    cell, _, ctrl, ref, num_tx = frame
    values = check.readings({0: _as_kept(*ctrl, torch.arange(1), num_tx)}, {0: ref})
    ok, lines = check.judge(values, cell.limits, 0)
    assert not ok, lines
    assert values["frames_err"] > cell.limits["frames_err"], lines
    assert values["estimate_err"] > cell.limits["estimate_err"], lines


def test_time_rank_is_67_in_both():
    """The reference's exact J0 and the port's A&S J0 both hold R_t at
    1621.5 Hz over 280 symbols at rank 67."""
    _, raw = _raw()
    assert time_rank(Carrier.from_config(raw), raw["doppler_hz_configured"]) == RANK
    assert auto_time_rank(experiment_config(raw)) == RANK


def test_the_solve_takes_the_blocked_route():
    _, raw = _raw()
    assert hpd_mod.plan(N, raw["num_rx"]).route == "blocked"
    assert all(hpd_mod._instance(N, raw["num_rx"], c) is None for c in hpd_mod.CLUSTER_SIZES)


def test_a_second_rank_search_builds_no_legendre_qr():
    """The rank search walks m = 2 … 67 at S = 280: 66 keys, every one of
    them kept by the cache, so a steady batch builds no QR on the host."""
    cfg = experiment_config(_raw()[1])
    auto_time_rank(cfg)
    before = profiling.counters.copy()
    assert auto_time_rank(cfg) == RANK
    assert dict(profiling.counters - before) == {"time_rank.computed": 1}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the blocked kernel has no CPU mode")
    return torch.device("cuda")


def _first_batch(card, monkeypatch):
    """(Program, draws, params, estimate, [(gram, rhs) of each HPD call])
    of the cell's first batch on the card."""
    cell, config = _raw()
    carrier = Carrier.from_config(config)
    inputs = draws.Inputs(SEED, config["batch"], carrier, cell.traffic, card)
    program = Program(config, cell.traffic, card)
    systems = []

    def spy(gram, rhs):
        systems.append((gram, rhs))
        return hpd_mod.hpd_solve(gram, rhs)

    monkeypatch.setattr(mmse_mod, "hpd_solve", spy)
    d, params = inputs(0)
    frames = program.simulate(d, program.frame_params(params))
    before = profiling.counters.copy()
    h = program.estimate(frames)
    moved = profiling.counters - before
    assert moved["ops.hpd_solve.blocked"] == 2 and profiling.launches("hpd_solve", moved) == 2
    return program, d, params, h, systems


#: the blocked kernel's float32 LDLᴴ against the exact solve of the same
#: complex64 systems (norm-wise): the rounding of a float32 elimination
#: amplified by the Wiener system's condition; read 8.4e-5 and 5.1e-5 on
#: the first batch's two calls (the plain Cholesky in complex64 2.5e-5 and
#: 4.6e-5). Each step of the refinement that ``mmse_full.solve`` runs shrinks
#: the error by about this factor
BLOCKED_ROUNDING = 5e-4
#: the solution once refined as ``mmse_full.solve`` refines it (the residual
#: in complex128, the correction by the blocked kernel): read 4.3e-9, held
#: under the estimate's own float32 rounding
REFINED = 1e-7


@pytest.mark.cuda
def test_blocked_route_on_the_cells_wiener_systems(card, monkeypatch):
    """Both calls of the first batch, (128, 603, 603) × 4: the blocked
    kernel against the plain Cholesky in complex128 on the same complex64
    systems, before and after one step of refinement, and each system
    alone the same bits as in its batch."""
    _, _, _, _, systems = _first_batch(card, monkeypatch)
    wide = torch.complex128
    for call, (gram, rhs) in enumerate(systems):
        assert gram.shape == (128, N, N) and rhs.shape == (128, N, 4)
        x = hpd_mod.hpd_solve(gram, rhs)
        exact = hpd_mod.hpd_solve_plain(gram.to(wide), rhs.to(wide))
        rel = lambda a: float(torch.linalg.norm(a.to(wide) - exact)  # noqa: E731
                              / torch.linalg.norm(exact))
        assert bool(torch.isfinite(x).all())
        assert rel(x) <= BLOCKED_ROUNDING, (call, rel(x))
        z = x.to(wide)
        z = z + hpd_mod.hpd_solve(gram, (rhs.to(wide) - gram.to(wide) @ z).to(gram.dtype)).to(wide)
        assert rel(z) <= REFINED, (call, rel(z))
        for i in (0, 77, 127):
            assert torch.equal(hpd_mod.hpd_solve(gram[i:i + 1], rhs[i:i + 1])[0], x[i])


@pytest.mark.cuda
def test_a_frame_keeps_its_bits_in_batches_of_32_and_more(card, monkeypatch):
    """A frame's estimate in the first 32 or 64 frames of the batch is the
    same bits as in all 128. Alone or in a batch of two it is not: cuBLAS
    takes other GEMM kernels there for the float64 products of the gram
    and of the residual, and the estimate moves within its float32
    rounding (1.7e-7 of its rms read), which this bounds."""
    program, d, params, h, _ = _first_batch(card, monkeypatch)
    for size in (64, 32, 2, 1):
        one = pipeline.BatchParams(*(p[:size] for p in params[:4]), params.profiles)
        frames = program.simulate(tuple(x[:size] for x in d), program.frame_params(one))
        got = program.estimate(frames)
        if size > 2:
            assert torch.equal(got, h[:size]), size
        else:
            rms = float(h[0].abs().pow(2).mean().sqrt())
            assert float((got[0] - h[0]).abs().max()) <= 1e-6 * rms, size
