"""The whole-frame cell ``lte_frame_etu300_4x4.mmse_full`` on the CPU: the
reference holds the port at one frame of 140 × 599 within the cell's
limits and the control fails them; both time ranks are 19, so the Wiener
system is n = 9 × 19 = 171 and takes the HPD solve's cluster route; and
``hpd_cluster_roofline`` reads the route's span, and nothing without it."""
import sys
import types
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.harness import check, draws, port_spans, spec, window  # noqa: E402
from benchmark.harness.program import Program, experiment_config  # noqa: E402
from benchmark.reference import pipeline  # noqa: E402
from benchmark.reference.carrier import Carrier  # noqa: E402
from benchmark.reference.estimators import time_rank  # noqa: E402
from benchmark.reference.precision import CONTROL, REFERENCE  # noqa: E402
from benchmark.work import hpd_solve as hpd_work, peaks  # noqa: E402

CELL = "lte_frame_etu300_4x4.mmse_full"
CONFIG = "lte_frame_etu300_4x4"
SEED = 2 ** 31 + 1907
H100 = "NVIDIA H100 80GB HBM3"


def _raw():
    return spec.load_json(REPO / "benchmark" / "configs" / f"{CONFIG}.json")


def _readings(prec=None):
    """The check's numbers of one frame of batch 0 at the published widths:
    of the port, or of the reference in precision ``prec`` in its place."""
    cell = spec.Cell(CELL)
    config = {**cell.config, "batch": 1, "check_range": 1, "check_batches": 1,
              "check_frames": 1, "reference_block": 1}
    carrier = Carrier.from_config(config)
    dev = torch.device("cpu")
    inputs = draws.Inputs(SEED, 1, carrier, cell.traffic, dev)
    idx = torch.arange(1)
    rank = time_rank(carrier, config["doppler_hz_configured"])
    d, params = inputs(0)
    ref = pipeline.run_batch(d, params, carrier, "mmse_full", "linear", rank, REFERENCE,
                             keep=[0], block=1)
    if prec is None:
        frames, h, score = window.one_batch(Program(config, cell.traffic, dev), inputs, 0)
        kept = window.keep(frames, h, score, idx)
    else:
        from benchmark.control import _as_kept
        out, score = pipeline.run_batch(d, params, carrier, "mmse_full", "linear", rank, prec,
                                        keep=[0], block=1)
        kept = _as_kept(out, score, idx, carrier.num_tx)
    return cell, check.readings({0: kept}, {0: ref})


def test_reference_holds_the_port():
    cell, values = _readings()
    assert values["pattern_mismatches"] == 0
    for number in ("frames_err", "estimate_err", "score_err"):
        assert values[number] < 1e-5, (number, values)
    ok, lines = check.judge(values, cell.limits, 0)
    assert ok, lines


def test_control_is_not_correct():
    cell, values = _readings(CONTROL)
    ok, lines = check.judge(values, cell.limits, 0)
    assert not ok, lines


def test_time_rank_is_19_in_both():
    """The reference's exact J0 and the port's A&S J0 both hold the 300 Hz
    time correlation over 140 symbols at rank 19."""
    from ce5g_torch.estimators.api import auto_time_rank

    raw = _raw()
    assert time_rank(Carrier.from_config(raw), raw["doppler_hz_configured"]) == 19
    assert auto_time_rank(experiment_config(raw)) == 19


def test_the_solve_takes_the_cluster_route():
    from ce5g_torch.ops import hpd_solve

    pl = hpd_solve.plan(9 * 19, _raw()["num_rx"])
    assert pl.route == "cluster" and pl.blocks == 2


def _ctx(reading):
    raw = _raw()
    carrier = Carrier.from_config(raw)
    params = types.SimpleNamespace(profiles=("ETU",))
    return types.SimpleNamespace(
        peaks=peaks.peaks_for(H100), rank=19, batch=raw["batch"], carrier=carrier,
        traced_inputs=lambda: [(params, None)], frame_paths=lambda p: [9, 9],
        _port_spans=reading)


def _reading(rows, under, batches=8):
    return port_spans.Reading(batches, rows, 0, 0, 0, 0.0, None, 0.0, 0.0, 0.0, under, {})


def _row(name, calls):
    return port_spans.Row(name, calls, 0.0, 0.0, calls, 0, 0.0)


def test_cluster_roofline_reads_the_route_span():
    reader = spec.Cell(CELL).reader("hpd_cluster_roofline")
    assert reader.read(_ctx(None)) is None  # no port spans at all
    parent = _reading([_row("ops.hpd_solve", 16)], {"ops.hpd_solve": 0.27})
    assert reader.read(_ctx(parent)) is None  # a port without route spans
    registers = _reading([_row("ops.hpd_solve", 16), _row("ops.hpd_solve.registers", 16)],
                         {"ops.hpd_solve": 0.27, "ops.hpd_solve.registers": 0.27})
    assert reader.read(_ctx(registers)) is None  # the solve took another route
    reading = _reading([_row("ops.hpd_solve", 16), _row("ops.hpd_solve.cluster", 16)],
                       {"ops.hpd_solve": 1.5, "ops.hpd_solve.cluster": 1.5})
    nbytes, flops = hpd_work.work(512, 171, 4)
    least = max(nbytes / 3.35e12, flops / 67e12)  # operations bind: 58 µs
    assert least == pytest.approx(flops / 67e12) and least == pytest.approx(58.1e-6, rel=1e-2)
    assert reader.read(_ctx(reading)) == pytest.approx(100 * 2 * least / 1.5e-3)
