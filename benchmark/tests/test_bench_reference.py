"""The benchmark's reference against the port, on the CPU, at a few
frames of each configuration (shrunk only in batch): the frames, the
estimates and the score. The port runs its kernels' plain versions here;
the reference imports nothing of it."""
import ast
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.harness import check, draws, spec, window  # noqa: E402
from benchmark.harness.program import Program  # noqa: E402
from benchmark.reference import pipeline  # noqa: E402
from benchmark.reference.carrier import Carrier, path_taps_amps  # noqa: E402
from benchmark.reference.estimators import time_rank  # noqa: E402
from benchmark.reference.precision import CONTROL, REFERENCE, tf32  # noqa: E402

CELLS = ("bench_4x4.mmse_full", "bench_4x4.ls", "nr100_4x64.mmse_full", "nr100_4x64.ls_cubic")
#: frames a batch on the CPU: the full widths of each configuration
SMALL = {"bench_4x4": 3, "nr100_4x64": 1}
SEED = 2 ** 31 + 99


def _small(cell: spec.Cell, frames=None):
    b = frames or SMALL[cell.workload["config"]]
    return {**cell.config, "batch": b, "check_range": 1, "check_batches": 1,
            "check_frames": b, "reference_block": 1}


def _readings(name: str, prec=None):
    """The check's numbers of batch 0 at the small size: of the port, or
    of the reference in precision ``prec`` put in its place."""
    cell = spec.Cell(name)
    config = _small(cell)
    carrier = Carrier.from_config(config)
    dev = torch.device("cpu")
    inputs = draws.Inputs(SEED, config["batch"], carrier, cell.traffic, dev)
    idx = torch.arange(config["batch"])
    rank = time_rank(carrier, config["doppler_hz_configured"])
    est, method = cell.traffic["estimator"], cell.traffic["method"]
    d, params = inputs(0)
    ref = pipeline.run_batch(d, params, carrier, est, method, rank, REFERENCE,
                             keep=idx.tolist(), block=1)
    if prec is None:
        frames, h, score = window.one_batch(Program(config, cell.traffic, dev), inputs, 0)
        kept = window.keep(frames, h, score, idx)
    else:
        from benchmark.control import _as_kept
        out, score = pipeline.run_batch(d, params, carrier, est, method, rank, prec,
                                        keep=idx.tolist(), block=1)
        kept = _as_kept(out, score, idx, carrier.num_tx)
    return cell, check.readings({0: kept}, {0: ref})


@pytest.mark.parametrize("name", CELLS)
def test_reference_holds_the_port(name):
    cell, values = _readings(name)
    assert values["pattern_mismatches"] == 0
    for number in ("frames_err", "estimate_err", "score_err"):
        assert values[number] < 1e-5, (number, values)
    ok, lines = check.judge(values, cell.limits, 0)
    assert ok, lines


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference a precision step lower (float32, TF32 matmul
    operands) in the port's place fails the cell's limits."""
    cell, values = _readings(name, CONTROL)
    ok, lines = check.judge(values, cell.limits, 0)
    assert not ok, lines


@pytest.mark.parametrize("config", ["bench_4x4", "nr100_4x64"])
def test_time_rank_is_the_ports(config):
    from ce5g_torch.estimators.api import auto_time_rank
    from benchmark.harness.program import experiment_config

    raw = spec.load_json(REPO / "benchmark" / "configs" / f"{config}.json")
    assert time_rank(Carrier.from_config(raw), raw["doppler_hz_configured"]) == \
        auto_time_rank(experiment_config(raw))


@pytest.mark.parametrize("config", ["bench_4x4", "nr100_4x64"])
def test_profile_tables_are_the_ports(config):
    """Taps, amplitudes and the used bins as the port's tables have them."""
    import numpy as np
    from ce5g_torch.physics import PROFILE_INDEX, table_for
    from benchmark.harness.program import experiment_config

    raw = spec.load_json(REPO / "benchmark" / "configs" / f"{config}.json")
    carrier = Carrier.from_config(raw)
    table = table_for(experiment_config(raw))
    assert carrier.num_subcarriers == len(table.used_bins)
    np.testing.assert_array_equal(carrier.used_bins, table.used_bins)
    for name, i in PROFILE_INDEX.items():
        taps, amp = path_taps_amps(name, carrier)
        valid = table.path_valid[i] > 0
        np.testing.assert_array_equal(taps[valid], table.delay_samples[i][valid])
        np.testing.assert_allclose(amp, table.amp_overwrite[i], rtol=1e-6)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0 - 2 ** -10])
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0 - 2 ** -9])
    assert torch.equal(tf32(x), want)
    z = torch.complex(x, -x)
    assert torch.equal(tf32(z.conj()), torch.complex(want, want))


def test_reference_imports_nothing_of_the_port():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("ce5g_torch", "ce5g_tpu", "jax", "benchmark"), \
                    (path.name, n)
