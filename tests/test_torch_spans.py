"""The port's spans and counters (``ce5g_torch.utils.profiling``) on the CPU.

Spans are off by default and then record nothing; inside ``recording()``
they nest with the right parents, in the order they opened, on the clock
of a profiler trace (``ts`` µs + ``baseTimeNanoseconds``); recording
leaves every output of the timed entry bit for bit as it was; and each
counter of the registry moves by one where its work happens. The kernels'
launches are counted here through stand-ins for the CUDA libraries: the
card tests of tests/test_torch_ops.py and tests/test_torch_envelope.py
count the real ones.
"""
import json
import types

import pytest
import torch

from ce5g_torch import ExperimentConfig, MIMOConfig, OFDMConfig
from ce5g_torch.estimators import estimate_batch
from ce5g_torch.estimators.api import auto_time_rank
from ce5g_torch.ops import _build
from ce5g_torch.ops import hpd_solve as hpd_mod
from ce5g_torch.ops import interp as slot_mod
from ce5g_torch.ops import interp_fused as grid_mod
from ce5g_torch.ops import nmse as nmse_mod
from ce5g_torch.physics import FrameParams, draw_frames, simulate_batch
from ce5g_torch.physics.profiles import cached
from ce5g_torch.physics.simulate import table_for
from ce5g_torch.utils import metrics, profiling

CPU = torch.device("cpu")
#: the estimators the benchmark's cells run
ESTIMATORS = (("ls", "linear"), ("ls", "cubic"), ("mmse_full", "linear"))


def _cfg():
    return ExperimentConfig(
        ofdm=OFDMConfig(fft_size=64, cp_length=8, num_symbols=6, useful_subcarriers=40),
        mimo=MIMOConfig(num_tx=2, num_rx=2),
    )


def _inputs(cfg, seed=5):
    params = FrameParams(torch.tensor([0, 1, 2], dtype=torch.int32),
                         torch.tensor([10.0, 100.0, 200.0]), torch.tensor([5.0, 15.0, 25.0]),
                         torch.tensor([0.05, 0.10, 0.15]))
    return draw_frames(torch.Generator().manual_seed(seed), params, cfg, device=CPU), params


def _step(cfg, estimator, method):
    """One batch of the timed entry: simulate, estimate, score."""
    draws, params = _inputs(cfg)
    frames = simulate_batch(draws, params, cfg=cfg, device=CPU)
    h = estimate_batch(frames, cfg=cfg, estimator=estimator, method=method, device=CPU)
    return frames, h, metrics.nmse(frames.channel, h)


def test_spans_off_record_nothing():
    first = profiling.annotate("a")
    assert first is profiling.annotate("b")  # one shared null context
    with first as inner:
        assert inner is None
    with profiling.recording() as spans:
        pass
    assert spans == []
    _step(_cfg(), "ls", "linear")  # recording is off again
    assert spans == []


def test_spans_nest_in_order():
    with profiling.recording() as spans:
        with profiling.annotate("root"):
            with profiling.annotate("a"):
                with profiling.annotate("a1"):
                    pass
            with profiling.annotate("b"):
                pass
        with profiling.annotate("second"):
            pass
    assert [(sp.name, sp.parent) for sp in spans] == [
        ("root", -1), ("a", 0), ("a1", 1), ("b", 0), ("second", -1)]
    for sp in spans:
        assert 0 < sp.start_ns <= sp.end_ns
        if sp.parent >= 0:
            up = spans[sp.parent]
            assert up.start_ns <= sp.start_ns and sp.end_ns <= up.end_ns
    assert [sp.start_ns for sp in spans] == sorted(sp.start_ns for sp in spans)
    assert spans[1].end_ns <= spans[3].start_ns and spans[0].end_ns <= spans[4].start_ns


def test_recording_gives_a_new_buffer_and_does_not_nest():
    with profiling.recording() as first:
        with profiling.annotate("x"):
            pass
        with pytest.raises(RuntimeError, match="already"):
            with profiling.recording():
                pass
    with profiling.recording() as second:
        pass
    assert [sp.name for sp in first] == ["x"] and second == [] and first is not second


def test_timed_entry_spans():
    """The spans of one batch of each benchmarked estimator, with parents."""
    cfg = _cfg()
    for estimator, method in ESTIMATORS:
        before = profiling.counters.copy()
        with profiling.recording() as spans:
            _step(cfg, estimator, method)
        moved = profiling.counters - before
        names = [sp.name for sp in spans]
        parent = {sp.name: (spans[sp.parent].name if sp.parent >= 0 else None) for sp in spans}
        assert names[:5] == ["physics.simulate", "physics.pattern", "physics.jakes",
                             "physics.response", "physics.received"]
        assert {parent[n] for n in names[1:5]} == {"physics.simulate"}
        assert parent["physics.simulate"] is None and parent["estimators.estimate"] is None
        assert names[-2:] == ["metrics.nmse", "ops.nmse"] and parent["metrics.nmse"] is None
        assert parent["ops.nmse"] == "metrics.nmse" and names.count("ops.nmse") == 1
        assert moved["ops.nmse.plain"] == 1 and profiling.launches("nmse", moved) == 0
        if estimator == "ls":
            kernel = "ops.interp_fused" if method == "linear" else "ops.interp"
            assert names[5:-2] == ["estimators.estimate", "ls.pilots", "ls.interpolate", kernel]
            assert parent[kernel] == "ls.interpolate"
        else:
            assert names[5:-2] == ["estimators.estimate", "mmse_full.rank", "mmse_full.ls_grid",
                                   "mmse_full.time_prior", "mmse_full.gram", "mmse_full.solve",
                                   "ops.hpd_solve", "ops.hpd_solve.plain",
                                   "ops.hpd_solve", "ops.hpd_solve.plain",
                                   "mmse_full.reconstruct"]
            assert [spans[sp.parent].name for sp in spans if sp.name == "ops.hpd_solve"] == [
                "mmse_full.solve"] * 2
            assert [spans[sp.parent].name for sp in spans
                    if sp.name == "ops.hpd_solve.plain"] == ["ops.hpd_solve"] * 2
        stages = [sp for sp in spans if sp.parent >= 0 and spans[sp.parent].parent == -1]
        assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))


def test_spans_share_the_profiler_clock(tmp_path):
    """Under a CPU profiler every span's ``record_function`` and every ATen
    operation inside it lie inside the span's interval, the trace's ``ts``
    mapped by ``baseTimeNanoseconds``."""
    cfg = _cfg()
    with profiling.recording() as spans:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _step(cfg, "mmse_full", "linear")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    chrome = json.loads((tmp_path / "trace.json").read_text())
    base = chrome["baseTimeNanoseconds"]
    events = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]
    marks = sorted((e for e in events if e.get("cat") == "user_annotation"),
                   key=lambda e: float(e["ts"]))
    assert [e["name"] for e in marks] == [sp.name for sp in spans]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
           for e in events if e.get("cat") == "cpu_op"]
    inside = 0
    for sp, mark in zip(spans, marks):
        lo, hi = (sp.start_ns - base) * 1e-3, (sp.end_ns - base) * 1e-3
        a, b = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
        assert lo <= a and b <= hi, (sp.name, lo, a, b, hi)
        for oa, ob in ops:
            if a <= oa and ob <= b:
                inside += 1
                assert lo <= oa and ob <= hi
    assert inside > 50


@pytest.mark.parametrize("estimator,method", ESTIMATORS)
def test_recording_leaves_outputs_bit_identical(estimator, method):
    cfg = _cfg()
    off = _step(cfg, estimator, method)
    with profiling.recording() as spans:
        on = _step(cfg, estimator, method)
    assert spans
    frames_off, h_off, score_off = off
    frames_on, h_on, score_on = on
    for a, b in zip(list(frames_off[:-1]) + [h_off, score_off],
                    list(frames_on[:-1]) + [h_on, score_on]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_trace_writes_spans_beside_the_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("stage"):
            with profiling.annotate("inner"):
                torch.ones(4).sum()
    assert list(tmp_path.glob("*.pt.trace.json"))
    (path,) = tmp_path.glob("spans.*.json")
    out = json.loads(path.read_text())
    assert out["clock"] == "time_ns"
    assert [(s["name"], s["parent"]) for s in out["spans"]] == [("stage", -1), ("inner", 0)]
    assert profiling.annotate("after") is profiling.annotate("off")


def _moved(fn):
    before = profiling.counters.copy()
    fn()
    return dict(profiling.counters - before)


@pytest.fixture
def fake_card(monkeypatch):
    """The kernels' C entry points and the CUDA stream replaced by stand-ins
    that launch nothing, so that each wrapper's ``_launch`` runs on CPU
    tensors."""
    lib = types.SimpleNamespace(interp_launch=lambda *a: 0, interp_fused_launch=lambda *a: 0,
                                nmse_launch=lambda *a: 0)
    monkeypatch.setattr(hpd_mod, "_launcher", lambda: (lambda *a: 0))
    monkeypatch.setattr(grid_mod, "_lib", lambda: lib)
    monkeypatch.setattr(slot_mod, "_lib", lambda: lib)
    monkeypatch.setattr(nmse_mod, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


HPD_ROUTE_SHAPES = {"registers": (45, 4), "cluster": (135, 4), "blocked": (400, 4)}


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card, so that ``hpd_solve``
    takes its launch path under ``fake_card``."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("route", hpd_mod.ROUTES)
def test_hpd_solve_counts_its_route(fake_card, route):
    """Each launch counts its route and runs in one span of the route's
    name, under the wrapper's ``ops.hpd_solve``."""
    n, r = HPD_ROUTE_SHAPES[route]
    pl = hpd_mod.plan(n, r)
    assert pl.route == route
    gram = torch.zeros(1, n, n, dtype=torch.complex64)
    rhs = torch.zeros(1, n, r, dtype=torch.complex64)
    assert _moved(lambda: hpd_mod._launch(pl, gram, rhs)) == {f"ops.hpd_solve.{route}": 1}
    with profiling.recording() as spans:
        moved = _moved(lambda: hpd_mod.hpd_solve(gram.as_subclass(_OnCard),
                                                 rhs.as_subclass(_OnCard)))
    assert moved == {f"ops.hpd_solve.{route}": 1}
    assert [(sp.name, sp.parent) for sp in spans] == [
        ("ops.hpd_solve", -1), (f"ops.hpd_solve.{route}", 0)]


@pytest.mark.parametrize("route", grid_mod.ROUTES)
def test_interp_fused_counts_its_route(fake_card, route):
    vals = torch.zeros(1, 4, 14, 599, dtype=torch.complex64)
    mask = torch.zeros(1, 14, 599)
    pl = grid_mod._plan(4, 14, 599, route)
    moved = _moved(lambda: grid_mod._launch(pl, vals, mask, "linear"))
    assert moved == {f"ops.interp_fused.{route}": 1}
    assert profiling.launches("interp_fused", moved) == 1


@pytest.mark.parametrize("route", slot_mod.ROUTES)
def test_interp_counts_its_route(fake_card, route):
    p = 64
    vals = torch.zeros(1, 4, p, dtype=torch.complex64)
    pos = torch.zeros(1, p, 2, dtype=torch.int32)
    valid = torch.zeros(1, p)
    pl = slot_mod._plan(4, p, 14, 599, route)
    moved = _moved(lambda: slot_mod._launch(pl, vals, pos, valid, (14, 599), "cubic"))
    assert moved == {f"ops.interp.{route}": 1}
    assert profiling.launches("interp", moved) == 1


@pytest.mark.parametrize("route", nmse_mod.ROUTES)
def test_nmse_counts_its_route(fake_card, route):
    h = torch.zeros(2, 14, 4, 4, 599, dtype=torch.complex64)
    e = torch.zeros(2, 4, 14, 599, dtype=torch.complex64).transpose(1, 2)[:, :, :, None, :]
    e = e.expand(h.shape)
    axes = None if route == "pairs" else (0,)  # the frame axis alone is not contiguous
    pl = nmse_mod.plan_for(tuple(h.shape), h.stride(), e.stride(), axes, 528)
    assert pl.route == route
    moved = _moved(lambda: nmse_mod._launch(pl, h, e))
    assert moved == {f"ops.nmse.{route}": 1}
    assert profiling.launches("nmse", moved) == 1


def test_time_rank_counts_each_run():
    cfg = _cfg()
    assert _moved(lambda: auto_time_rank(cfg)) == {"time_rank.computed": 1}
    moved = _moved(lambda: _step(cfg, "mmse_full", "linear"))
    assert moved["time_rank.computed"] == 1 and moved["ops.hpd_solve.plain"] == 2
    assert "time_rank.computed" not in _moved(lambda: _step(cfg, "ls", "linear"))


def test_tables_built_counts_each_miss():
    table = table_for(_cfg())
    key = ("test_tables_built_counts_each_miss", object())
    assert _moved(lambda: cached(table, key, lambda: 1)) == {"tables.built": 1}
    assert _moved(lambda: cached(table, key, lambda: 2)) == {}
    assert cached(table, key, lambda: 3) == 1


def test_kernels_loaded_counts_each_library(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", lambda names: {n: tmp_path / f"{n}.so" for n in names})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.SimpleNamespace(path=path))
    assert _moved(lambda: _build.library("interp")) == {"kernels.loaded": 1}
    assert _moved(lambda: _build.library("interp")) == {}
    assert _moved(lambda: _build.library("hpd_solve")) == {"kernels.loaded": 1}
