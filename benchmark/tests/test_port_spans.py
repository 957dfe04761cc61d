"""``harness.port_spans``: the attribution of a hand-made Chrome trace to
the port's spans (nested spans, a launch at a span's edge, a sync, idle
gaps, a launch outside every span, one the trace lacks), and the readers'
silence where there is nothing to read."""
import sys
import types
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.harness import port_spans  # noqa: E402

BASE = 1_700_000_000_000_000_000  # the trace's baseTimeNanoseconds


def _span(name, parent, a_us, b_us):
    return types.SimpleNamespace(name=name, parent=parent, start_ns=BASE + int(a_us * 1000),
                                 end_ns=BASE + int(b_us * 1000))


#: bench.estimate [0, 104] ⊃ estimators.estimate [10, 102] ⊃ mmse_full.gram
#: [20, 40] and mmse_full.time_prior [45, 100]; bench.score [104, 120] ⊃
#: metrics.nmse [105, 118]
SPANS = [_span("bench.estimate", -1, 0, 104), _span("estimators.estimate", 0, 10, 102),
         _span("mmse_full.gram", 1, 20, 40), _span("mmse_full.time_prior", 1, 45, 100),
         _span("bench.score", -1, 104, 120), _span("metrics.nmse", 4, 105, 118)]


def _chrome():
    def runtime(name, ts, dur=1.0, corr=None):
        e = {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur, "tid": 1,
             "args": {}}
        if corr is not None:
            e["args"]["correlation"] = corr
        return e

    ev = [runtime("cudaLaunchKernel", 25.0, corr=1),  # inside the gram
          runtime("cudaLaunchKernel", 40.0, corr=2),  # at the gram's last instant
          runtime("cudaLaunchKernel", 42.0, corr=3),  # in estimators.estimate only
          runtime("cudaLaunchKernel", 106.0, corr=4),  # in metrics.nmse
          runtime("cudaLaunchKernel", 130.0, corr=6),  # after every span
          runtime("cudaMemcpy", 3.0, 2.0, corr=7),  # a sync in a root, outside the port
          runtime("cudaStreamSynchronize", 50.0, 50.0),  # a sync in the time prior
          runtime("cudaMemcpyAsync", 60.0, 1.0, corr=8)]  # not a sync
    kernels = [(1, 26.0, 5.0), (2, 41.0, 2.0), (3, 43.0, 4.0), (4, 108.0, 6.0),
               (None, 115.0, 1.0), (6, 131.0, 1.0)]
    ev += [{"ph": "X", "cat": "kernel", "name": f"k{c}", "ts": t, "dur": d,
            "args": ({"correlation": c} if c else {}) | {"stream": 7}} for c, t, d in kernels]
    return {"baseTimeNanoseconds": BASE, "traceEvents": ev}


COUNTS = {"time_rank.computed": 1, "kernels.loaded": 1, "ops.hpd_solve.registers": 2}


def test_attribution_of_a_hand_made_trace():
    r = port_spans.attribute(_chrome(), SPANS, 1, COUNTS)
    assert (r.ops, r.outside, r.missing) == (6, 1, 1)
    rows = {row.name: row for row in r.rows}
    assert list(rows) == [sp.name for sp in SPANS]
    assert (rows["mmse_full.gram"].launches, rows["mmse_full.gram"].device_ms) == (
        2, pytest.approx(0.007))
    assert rows["estimators.estimate"].launches == 1
    assert rows["metrics.nmse"].launches == 1
    assert rows["mmse_full.time_prior"].launches == 0
    assert rows["estimators.estimate"].host_self_ms == pytest.approx((92 - 20 - 55) * 1e-3)
    assert rows["mmse_full.gram"].host_self_ms == pytest.approx(0.020)
    # the sync of the time prior counts; the root's cudaMemcpy lies outside the port
    assert rows["mmse_full.time_prior"].syncs == 1 and rows["bench.estimate"].syncs == 1
    assert r.syncs_per_batch == 1
    assert r.sync_calls == {"mmse_full.time_prior": {"cudaStreamSynchronize": 1},
                            "bench.estimate": {"cudaMemcpy": 1}}
    # idle gaps by midpoint: [0, 26] and [31, 41] the host in the port, [47, 108]
    # in the sync, [114, 115] in metrics.nmse, [116, 131] outside every span
    assert rows["mmse_full.time_prior"].idle_ms == pytest.approx(0.061)
    assert r.dispatch_idle_ms == pytest.approx((26 + 10 + 1) * 1e-3)
    # host time in the entries, 92 + 13 µs, less the 50 µs sync, over 4 launches
    assert r.host_us_per_launch == pytest.approx((92 + 13 - 50) / 4)
    assert r.host_rebuilds_per_batch == 2
    assert r.device_ms_under["mmse_full.gram"] == pytest.approx(0.007)
    assert r.device_ms_under["bench.estimate"] == pytest.approx(0.011)
    assert r.window_ms == pytest.approx(0.132)
    assert len(r.table()) == 1 + len(SPANS)
    two = port_spans.attribute(_chrome(), SPANS, 2, COUNTS)
    assert two.syncs_per_batch == 0.5 and two.host_rebuilds_per_batch == 1


def test_attribution_needs_spans_and_the_trace_clock():
    chrome = _chrome()
    assert port_spans.attribute(chrome, [], 1, COUNTS) is None
    del chrome["baseTimeNanoseconds"]
    assert port_spans.attribute(chrome, SPANS, 1, COUNTS) is None


@pytest.mark.parametrize("name,sync", [("cudaStreamSynchronize", True), ("cudaMemcpy", True),
                                       ("cudaMemcpy_v3020", True), ("cudaMemcpy2D", True),
                                       ("cudaEventSynchronize", True),
                                       ("cudaMemcpyAsync", False), ("cudaLaunchKernel", False),
                                       ("cudaEventRecord", False)])
def test_sync_calls(name, sync):
    assert port_spans.is_sync(name) is sync


def test_reading_is_made_once_and_only_on_the_card(monkeypatch):
    calls = []
    real = port_spans.measure
    monkeypatch.setattr(port_spans, "measure", lambda ctx: calls.append(ctx) or real(ctx))
    ctx = types.SimpleNamespace(trace=object(), traced=[0], device=torch.device("cpu"))
    assert port_spans.of(ctx) is None and port_spans.of(ctx) is None
    assert len(calls) == 1


def test_a_port_without_spans_gives_no_reading(monkeypatch):
    """A commit before the port's spans: ``utils.profiling`` lacks
    ``recording`` and ``counters``; nothing is run and nothing raises."""
    monkeypatch.setattr(port_spans, "profiling", types.SimpleNamespace(annotate=lambda n: None))
    ctx = types.SimpleNamespace(trace=object(), traced=[0],
                                device=types.SimpleNamespace(type="cuda"))
    assert port_spans.measure(ctx) is None
