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
import collections
import json
import types

import pytest
import torch

from ce5g_torch import ExperimentConfig, MIMOConfig, OFDMConfig
from ce5g_torch.estimators import estimate_batch
from ce5g_torch.estimators.time_prior import auto_time_rank, legendre_qr
from ce5g_torch.ops import _build
from ce5g_torch.ops import channel as channel_mod
from ce5g_torch.ops import hpd_solve as hpd_mod
from ce5g_torch.ops import interp as slot_mod
from ce5g_torch.ops import interp_fused as grid_mod
from ce5g_torch.ops import nmse as nmse_mod
from ce5g_torch.ops import pilot_select as select_mod
from ce5g_torch.ops import profile_gram as gram_mod
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
        assert names[:8] == ["physics.simulate", "physics.pattern", "ops.pilot_select",
                             "ops.pilot_select.plain", "physics.jakes", "physics.channel",
                             "ops.channel", "ops.channel.plain"]
        assert {parent[n] for n in names[1:2] + names[4:6]} == {"physics.simulate"}
        assert parent["ops.channel"] == "physics.channel"
        assert parent["ops.channel.plain"] == "ops.channel" and names.count("ops.channel") == 1
        assert moved["ops.channel.plain"] == 1 and profiling.launches("channel", moved) == 0
        assert parent["ops.pilot_select"] == "physics.pattern"
        assert parent["ops.pilot_select.plain"] == "ops.pilot_select"
        assert names.count("ops.pilot_select") == 1
        assert moved["ops.pilot_select.plain"] == 1 and profiling.launches("pilot_select", moved) == 0
        assert parent["physics.simulate"] is None and parent["estimators.estimate"] is None
        assert names[-3:] == ["metrics.nmse", "ops.nmse", "ops.nmse.plain"]
        assert parent["metrics.nmse"] is None and parent["ops.nmse"] == "metrics.nmse"
        assert parent["ops.nmse.plain"] == "ops.nmse" and names.count("ops.nmse") == 1
        assert moved["ops.nmse.plain"] == 1 and profiling.launches("nmse", moved) == 0
        if estimator == "ls":
            kernel = "ops.interp_fused" if method == "linear" else "ops.interp"
            assert names[8:-3] == ["estimators.estimate", "ls.pilots", "ls.interpolate", kernel,
                                   f"{kernel}.plain"]
            assert parent[kernel] == "ls.interpolate" and parent[f"{kernel}.plain"] == kernel
        else:
            assert names[8:-3] == ["estimators.estimate", "mmse_full.rank",
                                   "mmse_full.time_prior", "mmse_full.gram",
                                   "mmse_full.profiles", "ops.profile_gram",
                                   "ops.profile_gram.plain", "mmse_full.solve",
                                   "ops.hpd_solve", "ops.hpd_solve.plain",
                                   "ops.hpd_solve", "ops.hpd_solve.plain",
                                   "mmse_full.reconstruct"]
            assert parent["mmse_full.profiles"] == "mmse_full.gram"
            assert parent["ops.profile_gram"] == "mmse_full.profiles"
            assert parent["ops.profile_gram.plain"] == "ops.profile_gram"
            assert moved["ops.profile_gram.plain"] == 1
            assert profiling.launches("profile_gram", moved) == 0
            assert moved["mmse_full.profile_tables"] == 3  # the plain version: EPA, EVA, ETU
            assert [spans[sp.parent].name for sp in spans if sp.name == "ops.hpd_solve"] == [
                "mmse_full.solve"] * 2
            assert [spans[sp.parent].name for sp in spans
                    if sp.name == "ops.hpd_solve.plain"] == ["ops.hpd_solve"] * 2
        stages = [sp for sp in spans if sp.parent >= 0 and spans[sp.parent].parent == -1]
        assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))


@pytest.mark.parametrize("mix", [(0, 0, 0), (2, 2, 2), (0, 1, 2)])
def test_profile_tables_rise_by_every_profile(mix):
    """On the CPU ``ops.profile_gram``'s plain version contracts every frame
    against all three profile tables, whatever profiles the batch holds: the
    counter rises by 3 a call (by 1 a kernel call:
    ``test_profile_gram_counts_its_route``)."""
    cfg = _cfg()
    draws, params = _inputs(cfg)
    params = params._replace(profile_idx=torch.tensor(mix, dtype=torch.int32))
    frames = simulate_batch(draws, params, cfg=cfg, device=CPU)
    before = profiling.counters.copy()
    for _ in range(2):
        estimate_batch(frames, cfg=cfg, estimator="mmse_full", device=CPU)
    assert (profiling.counters - before)["mmse_full.profile_tables"] == 6


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
def fake_stream(monkeypatch):
    """The CUDA stream and the card's SMs replaced by stand-ins."""
    monkeypatch.setattr(select_mod, "_SMS", {0: 132})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


@pytest.fixture
def fake_card(monkeypatch, fake_stream):
    """Every kernel's C entry point (``_build._bind``, the seam that the five
    wrappers bind through) replaced by a stand-in that launches nothing, so
    that each wrapper's ``_launch`` runs on CPU tensors."""
    monkeypatch.setattr(_build, "_bind", lambda *a: (lambda *args: 0))


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
    with profiling.recording() as spans:
        moved = _moved(lambda: grid_mod._launch(pl, vals, mask, "linear"))
    assert moved == {f"ops.interp_fused.{route}": 1}
    assert [(sp.name, sp.parent) for sp in spans] == [(f"ops.interp_fused.{route}", -1)]
    assert profiling.launches("interp_fused", moved) == 1


@pytest.mark.parametrize("route", slot_mod.ROUTES)
def test_interp_counts_its_route(fake_card, route):
    p = 64
    vals = torch.zeros(1, 4, p, dtype=torch.complex64)
    pos = torch.zeros(1, p, 2, dtype=torch.int32)
    valid = torch.zeros(1, p)
    pl = slot_mod._plan(4, p, 14, 599, route)
    with profiling.recording() as spans:
        moved = _moved(lambda: slot_mod._launch(pl, vals, pos, valid, (14, 599), "cubic"))
    assert moved == {f"ops.interp.{route}": 1}
    assert [(sp.name, sp.parent) for sp in spans] == [(f"ops.interp.{route}", -1)]
    assert profiling.launches("interp", moved) == 1


@pytest.mark.parametrize("route", nmse_mod.ROUTES)
def test_nmse_counts_its_route(fake_card, route):
    h = torch.zeros(2, 14, 4, 4, 599, dtype=torch.complex64)
    e = torch.zeros(2, 4, 14, 599, dtype=torch.complex64).transpose(1, 2)[:, :, :, None, :]
    e = e.expand(h.shape)
    axes = None if route == "pairs" else (0,)  # the frame axis alone is not contiguous
    pl = nmse_mod.plan_for(tuple(h.shape), h.stride(), e.stride(), axes, 528)
    assert pl.route == route
    with profiling.recording() as spans:
        moved = _moved(lambda: nmse_mod._launch(pl, h, e))
    assert moved == {f"ops.nmse.{route}": 1}
    assert [(sp.name, sp.parent) for sp in spans] == [(f"ops.nmse.{route}", -1)]
    assert profiling.launches("nmse", moved) == 1


@pytest.mark.parametrize("route", channel_mod.ROUTES)
def test_channel_counts_its_route(fake_card, route):
    """Each call launches once by the route its TX grid's T extent gives,
    in the span of its route inside one ``ops.channel`` span."""
    b, s, r, t, p, k = 2, 14, 4, 4, 9, 599
    gains = torch.zeros(b, s, r, t, p, dtype=torch.complex64).as_subclass(_OnCard)
    grid = torch.zeros(b, s, 1 if route == "common" else t, k, dtype=torch.complex64)
    noise = torch.zeros(b, s, r, k).as_subclass(_OnCard)
    args = (torch.zeros(3, p, k, dtype=torch.complex64).as_subclass(_OnCard),
            torch.zeros(b, dtype=torch.int64).as_subclass(_OnCard), grid.as_subclass(_OnCard),
            torch.zeros(b).as_subclass(_OnCard), noise, noise)
    assert channel_mod.plan(gains, grid).route == route
    with profiling.recording() as spans:
        moved = _moved(lambda: channel_mod.channel(gains, *args))
    assert moved == {f"ops.channel.{route}": 1}
    assert profiling.launches("channel", moved) == 1
    assert [(sp.name, sp.parent) for sp in spans] == [
        ("ops.channel", -1), (f"ops.channel.{route}", 0)]


#: (B, S, R, K) a route's plan takes: all of a row's antennas a block, or shared
GRAM_ROUTE_SHAPES = {"whole": (2048, 14, 2, 599), "split": (2, 14, 4, 599)}


def _gram_inputs(b, s, r, k):
    c64 = torch.complex64
    tables = gram_mod.FTables(None, None, 3, 9, torch.zeros(3, k, 9, dtype=c64))
    return (torch.zeros(b, s, r, k, dtype=c64), torch.zeros(b, s, k, dtype=c64),
            torch.zeros(b, s, k), tables, torch.zeros(b, dtype=torch.int64))


@pytest.mark.parametrize("route", gram_mod.ROUTES)
def test_profile_gram_counts_its_route(fake_card, route):
    """Each call launches once by the route its plan gives, in the span of
    its route inside one ``ops.profile_gram`` span, and contracts each frame
    against one profile table."""
    rx, tx, mask, tables, pidx = _gram_inputs(*GRAM_ROUTE_SHAPES[route])
    on_card = [x.as_subclass(_OnCard) for x in (rx, tx, mask, tables.freq_kp, pidx)]
    tables = tables._replace(freq_kp=on_card[3])
    assert gram_mod.plan(rx, tables).route == route
    with profiling.recording() as spans:
        moved = _moved(lambda: gram_mod.profile_gram(*on_card[:3], tables, on_card[4]))
    assert moved == {f"ops.profile_gram.{route}": 1, "mmse_full.profile_tables": 1}
    assert profiling.launches("profile_gram", moved) == 1
    assert [(sp.name, sp.parent) for sp in spans] == [
        ("ops.profile_gram", -1), (f"ops.profile_gram.{route}", 0)]


SELECT_ROUTE_SHAPES = {"block": (256, 14, 599), "cluster": (2, 140, 599),
                      "global": (1, 2, (select_mod.MAX_RESIDENT + 1) // 2)}


@pytest.mark.parametrize("route", select_mod.ROUTES)
def test_pilot_select_counts_its_route(fake_card, route):
    """Each launch counts its route, one launch, in the span of its route
    inside one ``ops.pilot_select`` span."""
    b, s, k = SELECT_ROUTE_SHAPES[route]
    u = torch.zeros(b, s * k)
    n = torch.full((b,), s * k // 10, dtype=torch.int32)
    assert select_mod.plan_for(b, s * k, 132).route == route
    with profiling.recording() as spans:
        moved = _moved(lambda: select_mod.pilot_select(u.as_subclass(_OnCard),
                                                       n.as_subclass(_OnCard), s, k, s * k // 8))
    assert moved == {f"ops.pilot_select.{route}": 1}
    assert profiling.launches("pilot_select", moved) == 1
    assert [(sp.name, sp.parent) for sp in spans] == [
        ("ops.pilot_select", -1), (f"ops.pilot_select.{route}", 0)]


def _one_launch(kernel):
    """One launch of ``kernel`` through its wrapper's ``_launch`` on CPU
    tensors (a plan the card would take), and the route it counts."""
    c64 = torch.complex64
    if kernel == "hpd_solve":
        pl = hpd_mod.plan(45, 4)
        return pl.route, lambda: hpd_mod._launch(pl, torch.zeros(1, 45, 45, dtype=c64),
                                                 torch.zeros(1, 45, 4, dtype=c64))
    if kernel == "interp_fused":
        pl = grid_mod.plan(4, 14, 599)
        return pl.route, lambda: grid_mod._launch(pl, torch.zeros(1, 4, 14, 599, dtype=c64),
                                                  torch.zeros(1, 14, 599), "linear")
    if kernel == "interp":
        pl = slot_mod.plan(4, 64, 14, 599)
        return pl.route, lambda: slot_mod._launch(
            pl, torch.zeros(1, 4, 64, dtype=c64), torch.zeros(1, 64, 2, dtype=torch.int32),
            torch.zeros(1, 64), (14, 599), "cubic")
    if kernel == "nmse":
        h = torch.zeros(2, 14, 4, 4, 599, dtype=c64)
        pl = nmse_mod.plan_for(tuple(h.shape), h.stride(), h.stride(), None, 528)
        return pl.route, lambda: nmse_mod._launch(pl, h, h)
    if kernel == "channel":
        gains = torch.zeros(2, 14, 4, 4, 9, dtype=c64)
        grid = torch.zeros(2, 14, 1, 599, dtype=c64)
        noise = torch.zeros(2, 14, 4, 599)
        pl = channel_mod.plan(gains, grid)
        return pl.route, lambda: channel_mod._launch(
            pl, gains, torch.zeros(3, 9, 599, dtype=c64), torch.zeros(2, dtype=torch.int64),
            grid, torch.zeros(2), noise, noise)
    if kernel == "profile_gram":
        rx, tx, mask, tables, pidx = _gram_inputs(2, 14, 4, 599)
        pl = gram_mod.plan(rx, tables)
        return pl.route, lambda: gram_mod._launch(pl, rx, tx, mask, tables.freq_kp, pidx)
    pl = select_mod.plan_for(4, 14 * 599, 132)
    return pl.route, lambda: select_mod._launch(
        pl, torch.zeros(4, 14 * 599), torch.full((4,), 838, dtype=torch.int32), 14, 599, 1024)


class _FakeEntry:
    """A stand-in for a ctypes function: counts how often its types are
    set and it is called, and converts each argument by its declared type
    as ctypes would."""

    def __init__(self, status=0):
        self.sets = collections.Counter()
        self.calls = 0
        self.status = status

    def __setattr__(self, name, value):
        if name in ("argtypes", "restype"):
            self.sets[name] += 1
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        assert len(args) == len(self.argtypes)
        for arg, t in zip(args, self.argtypes):
            t.from_param(arg)
        self.calls += 1
        return self.status


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_a_failed_launch_raises_naming_its_kernel(monkeypatch, fake_stream, kernel):
    """A launch whose C entry returns a CUDA error raises RuntimeError with
    the kernel's name and the error's string, and counts no launch."""
    fake = {f"{kernel}_launch": _FakeEntry(status=700),
            "ce5g_error_string": lambda status: b"an illegal memory access was encountered"}
    monkeypatch.setattr(_build, "_bound", {})
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(**fake))
    route, run = _one_launch(kernel)

    def failing():
        with pytest.raises(RuntimeError, match=rf"^{kernel} kernel: CUDA error 700 \(an "
                                               r"illegal memory access was encountered\)$"):
            run()

    assert _moved(failing) == {}


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_a_kernel_is_bound_once(monkeypatch, fake_stream, kernel):
    """Repeated launches load the library and set the entry's types once;
    each launch runs in its route's span and counts it."""
    entry = _FakeEntry()
    loads = []

    def library(name):
        loads.append(name)
        return types.SimpleNamespace(**{f"{kernel}_launch": entry})

    monkeypatch.setattr(_build, "_bound", {})
    monkeypatch.setattr(_build, "library", library)
    route, run = _one_launch(kernel)
    with profiling.recording() as spans:
        moved = _moved(lambda: [run() for _ in range(3)])
    assert loads == [kernel] and entry.calls == 3
    assert entry.sets == {"argtypes": 1, "restype": 1}
    assert moved == {f"ops.{kernel}.{route}": 3}
    assert [sp.name for sp in spans] == [f"ops.{kernel}.{route}"] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("estimator,method", ESTIMATORS)
def test_timed_entry_launches_the_pilot_kernel_once(estimator, method):
    """On the card a batch of the timed entry selects its pilots in one
    launch, inside ``physics.pattern``, and never runs the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cfg = _cfg()
    draws, params = _inputs(cfg)
    before = profiling.counters.copy()
    with profiling.recording() as spans:
        frames = simulate_batch(draws, params, cfg=cfg, device="cuda")
        estimate_batch(frames, cfg=cfg, estimator=estimator, method=method, device="cuda")
        torch.cuda.synchronize()
    moved = profiling.counters - before
    selected = {key: n for key, n in moved.items() if key.startswith("ops.pilot_select.")}
    assert selected == {"ops.pilot_select.block": 1}  # 3 frames of 6 × 39: one block each
    assert profiling.launches("pilot_select", moved) == 1
    assert [spans[sp.parent].name for sp in spans if sp.name == "ops.pilot_select"] == [
        "physics.pattern"]


def test_time_rank_counts_each_run():
    cfg = _cfg()
    auto_time_rank(cfg)  # the search's Legendre QRs built once, then cached
    assert _moved(lambda: auto_time_rank(cfg)) == {"time_rank.computed": 1}
    moved = _moved(lambda: _step(cfg, "mmse_full", "linear"))
    assert moved["time_rank.computed"] == 1 and moved["ops.hpd_solve.plain"] == 2
    assert "time_rank.computed" not in _moved(lambda: _step(cfg, "ls", "linear"))


def test_legendre_built_counts_each_miss():
    assert _moved(lambda: legendre_qr(997, 3)) == {"time_prior.legendre_built": 1}
    assert _moved(lambda: legendre_qr(997, 3)) == {}


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
