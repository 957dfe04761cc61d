"""The high-speed-train cell ``nr_frame_hst500_4x4.mmse_full`` on the CPU:
its files as the harness finds them, the per-layer metrics it lists, and
``hpd_solve_roofline`` reading the HPD solve's ``blocked`` kernel. The
reference holding the port at one frame of 280 × 611, the time ranks and
the route are ``tests/test_torch_hst_frame.py``'s."""
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.harness import spec, trace  # noqa: E402
from benchmark.reference.carrier import Carrier, path_taps_amps  # noqa: E402
from benchmark.work import hpd_solve as hpd_work, peaks  # noqa: E402

CELL = "nr_frame_hst500_4x4.mmse_full"
H100 = "NVIDIA H100 80GB HBM3"


def test_the_cell_is_the_published_frame():
    """One 10 ms frame of 280 symbols at 30 kHz on 51 PRB (611 subcarriers
    used), at 500 km/h on 3.5 GHz, every ETU path on a tap of its own."""
    cell = spec.Cell(CELL)
    carrier = Carrier.from_config(cell.config)
    assert carrier.num_subcarriers == 51 * 12 - 1
    # 9.99 ms: CP 72 on every symbol; 20 symbols of the frame have 16 samples more
    assert carrier.num_symbols * carrier.symbol_duration == pytest.approx(10e-3, rel=2e-3)
    fd = 500 / 3.6 * cell.config["carrier_freq"] / 299_792_458.0
    assert cell.config["doppler_hz_configured"] == [round(fd, 1)] == [cell.traffic["doppler_hz"]]
    assert int((path_taps_amps("ETU", carrier)[1] > 0).sum()) == 9
    assert cell.workload["chips"] == 1 and cell.traffic["estimator"] == "mmse_full"
    listed = {m["name"] for m in cell.metrics(per_layer=True) if "workloads" in m}
    assert listed == {"hpd_solve_roofline", "wiener_gram_ms", "nmse_roofline",
                      "channel_roofline", "profile_gram_roofline"}


def _ctx(tr, rank=67):
    raw = spec.Cell(CELL).config
    params = types.SimpleNamespace(profiles=("ETU",))
    return types.SimpleNamespace(
        trace=tr, peaks=peaks.peaks_for(H100), rank=rank, batch=raw["batch"],
        carrier=Carrier.from_config(raw), traced_inputs=lambda: [(params, None)],
        frame_paths=lambda p: [9, 9])


def _trace(kernel, calls, dur_us):
    ops = [trace.DeviceOp(f"{kernel}(float2 const*, float2 const*, float2*, int, int)",
                          "kernel", 7, 0.0, dur_us, "bench.estimate") for _ in range(calls)]
    return trace.Trace(8, 1.0, 1.0, ops, 0, [])


def test_hpd_solve_roofline_reads_the_blocked_kernel():
    """Two calls a batch over 8 traced batches, each call one launch of the
    blocked kernel: the least time of a call at (128, 603, 603) × 4 over the
    kernel's mean time."""
    reader = spec.Cell(CELL).reader("hpd_solve_roofline")
    blocked = _trace("hpd_solve_blocked_kernel", 16, 15_000.0)
    assert reader.read(_ctx(None)) is None  # no trace at all
    assert reader.read(_ctx(_trace("sgemm_nn", 16, 15_000.0))) is None  # no HPD kernel
    assert reader.read(_ctx(blocked, rank=None)) is None  # no time rank, no system size
    nbytes, flops = hpd_work.work(128, 603, 4)
    least = max(nbytes / 3.35e12, flops / 67e12)  # operations bind: 0.58 ms
    assert least == pytest.approx(flops / 67e12) and least == pytest.approx(0.581e-3, rel=1e-2)
    assert reader.read(_ctx(blocked)) == pytest.approx(100 * least / 15e-3)
