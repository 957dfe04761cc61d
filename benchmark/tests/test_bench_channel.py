"""``work.channel``'s count at the three card-bound cells' shapes, and
``channel_roofline``: it reads the port's ``ops.channel.<route>`` spans and
gives nothing without them, as on a port whose physics is PyTorch's
operators."""
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.harness import port_spans, spec  # noqa: E402
from benchmark.reference.carrier import Carrier  # noqa: E402
from benchmark.work import channel, peaks  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
#: cell → (B, S, R, T, K), bytes in GB, least ms at 3.35 TB/s
CELLS = {"nr100_4x64.ls_cubic": ((64, 14, 64, 4, 3275), 9.04, 2.70),
         "nr100_4x64.mmse_full": ((64, 14, 64, 4, 3275), 9.04, 2.70),
         "lte_frame_etu300_4x4.mmse_full": ((512, 140, 4, 4, 599), 8.59, 2.56)}


def _ctx(cell, reading):
    raw = spec.Cell(cell).config
    params = types.SimpleNamespace(profiles=("ETU",))
    return types.SimpleNamespace(
        peaks=peaks.peaks_for(H100), batch=raw["batch"], carrier=Carrier.from_config(raw),
        traced_inputs=lambda: [(params, None)], frame_paths=lambda p: [9] * raw["batch"],
        _port_spans=reading)


def _reading(rows, under, batches=8):
    return port_spans.Reading(batches, rows, 0, 0, 0, 0.0, None, 0.0, 0.0, 0.0, under, {})


def _row(name, calls):
    return port_spans.Row(name, calls, 0.0, 0.0, calls, 0, 0.0)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_channel_count_and_roofline(cell):
    (b, s, r, t, k), gb, ms = CELLS[cell]
    c = _ctx(cell, None).carrier
    assert (c.num_symbols, c.num_rx, c.num_tx, c.num_subcarriers) == (s, r, t, k)
    nbytes, flops = channel.work(s, r, t, k, [9] * b)
    assert nbytes == 8 * b * s * r * t * k + 16 * b * s * r * k + 8 * b * s * k
    assert flops == b * (72 * s * r * t * k + 2 * 3 * 9 * s * r + 86 * s * r * k)
    assert round(nbytes / 1e9, 2) == gb
    least = peaks.least_seconds(nbytes, {"fp32": flops}, peaks.peaks_for(H100))
    assert least == pytest.approx(nbytes / 3.35e12) and round(least * 1e3, 2) == ms  # bytes bind

    reader = spec.Cell(cell).reader("channel_roofline")
    assert reader.read(_ctx(cell, None)) is None  # no port spans at all
    parent = _reading([_row("physics.response", 8), _row("physics.received", 8)],
                      {"physics.response": 62.6, "physics.received": 73.1})
    assert reader.read(_ctx(cell, parent)) is None  # the parent: PyTorch's operators
    plain = _reading([_row("ops.channel", 8), _row("ops.channel.plain", 8)],
                     {"ops.channel": 100.0, "ops.channel.plain": 100.0})
    assert reader.read(_ctx(cell, plain)) is None  # no launch
    kernel = _reading([_row("physics.channel", 8), _row("ops.channel", 8),
                       _row("ops.channel.common", 8)],
                      {"physics.channel": 3.5, "ops.channel": 3.5, "ops.channel.common": 3.4})
    assert reader.read(_ctx(cell, kernel)) == pytest.approx(100 * least / 3.4e-3)
