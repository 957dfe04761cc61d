"""The harness on the CPU at a tiny batch: a sound run is correct; with the
timed path broken underneath it is not; nothing a run imports is JAX or
the JAX package; a new configuration, traffic mix or metric is found by
its file alone; the trace is reduced as its note says. One test drives
``run.py`` on the card and skips without one."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.harness import program, runner, trace  # noqa: E402

CELLS = ("bench_4x4.mmse_full", "bench_4x4.ls", "nr100_4x64.mmse_full", "nr100_4x64.ls_cubic")
#: every frame checked, the window as short as the sampled batches allow
TINY = {"batch": 2, "check_range": 2, "check_batches": 1, "check_frames": 2,
        "reference_block": 1, "trace_batches": 2, "max_batches": 64}
SEED = 2 ** 31 + 4242


def _run(cell, **kw):
    return runner.run(cell, SEED, 0.0, kw.pop("trace", False), device="cpu",
                      overrides={**TINY, **kw.pop("overrides", {})}, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["check_lines"]
    assert out["failed"] == 0 and out["attempted"] >= 2 * TINY["batch"]
    assert list(out)[-2:] == ["checks", "check_lines"]


def _altered_estimate(self, frames):
    return program.Program._estimate(self, frames) * (1 + 1e-3)


def _stale_estimate(self, frames):
    """The step returns its state unchanged: the first estimate, ever after."""
    if not hasattr(self, "_first"):
        self._first = program.Program._estimate(self, frames)
    return self._first


def _half_batch_score(self, frames, h):
    half = frames.channel.shape[0] // 2
    return program.nmse(frames.channel[:half], h[:half])


def _altered_channel(self, draws, params):
    frames = program.Program._simulate(self, draws, params)
    return frames._replace(channel=frames.channel * (1 + 1e-3))


FAULTS = {"altered_estimate": ("estimate", _altered_estimate),
          "stale_estimate": ("estimate", _stale_estimate),
          "half_batch_score": ("score", _half_batch_score),
          "altered_channel": ("simulate", _altered_channel)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    name, broken = FAULTS[fault]
    monkeypatch.setattr(program.Program, f"_{name}", getattr(program.Program, name),
                        raising=False)
    monkeypatch.setattr(program.Program, name, broken)
    out = _run(cell)
    assert not out["correct"], out["check_lines"]


@pytest.mark.parametrize("cell", CELLS)
def test_no_run_imports_jax_or_the_jax_package(cell):
    """A run of each cell, in a fresh process: no module whose top-level
    name is jax, jaxlib, flax or ce5g_tpu is loaded."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmark import run\n"
        "from benchmark.harness import runner\n"
        "runner.run(%r, 7, 0.0, False, device='cpu', overrides=%r)\n"
        "print(json.dumps(run.loaded_forbidden()))\n" % (str(REPO), cell, TINY))
    env = {k: v for k, v in __import__("os").environ.items() if not k.startswith("JAX")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jax_like_but_not", object())
    monkeypatch.setitem(sys.modules, "ce5g_tpu_extra.sub", object())
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "ce5g_tpu.physics", object())
    assert run.loaded_forbidden() == ["ce5g_tpu"]


def test_new_files_are_found_by_name(tmp_path):
    """A new configuration, traffic mix, limits and metric reader, named in
    BENCHMARK.json, run without an edit to any file that is there."""
    bench_dir = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(REPO / "benchmark" / sub, bench_dir / sub)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    config = json.loads((REPO / "benchmark" / "configs" / "bench_4x4.json").read_text())
    config.update(name="tiny_2x2", num_tx=2, num_rx=2, **TINY)
    (bench_dir / "configs" / "tiny_2x2.json").write_text(json.dumps(config))
    traffic = json.loads((REPO / "benchmark" / "traffic" / "ls.json").read_text())
    traffic.update(method="nearest", profile=["EPA", "EVA"], snr_db={"uniform": [0.0, 20.0]},
                   doppler_hz=[10.0, 100.0])
    (bench_dir / "traffic" / "ls_nearest_mix.json").write_text(json.dumps(traffic))
    (bench_dir / "limits" / "tiny_2x2.ls_nearest_mix.json").write_text(
        (REPO / "benchmark" / "limits" / "bench_4x4.ls.json").read_text())
    (bench_dir / "metrics" / "frames_per_batch.py").write_text(
        "def read(ctx):\n    return ctx.window.batches and ctx.batch\n")
    spec["configs"].append({"name": "tiny_2x2", "source": "test", "reduced": [], "why": "test",
                            "file": "benchmark/configs/tiny_2x2.json"})
    spec["workloads"].append({"name": "tiny_2x2.ls_nearest_mix", "config": "tiny_2x2",
                              "traffic": "ls_nearest_mix", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "frames_per_batch", "unit": "frames", "better": "higher",
                               "bound": 0.01, "source": "host_clock",
                               "workloads": ["tiny_2x2.ls_nearest_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = runner.run("tiny_2x2.ls_nearest_mix", SEED, 0.0, False, device="cpu",
                     repo=tmp_path, root=bench_dir)
    assert out["correct"], out["check_lines"]
    assert out["metrics"]["frames_per_batch"]["value"] == TINY["batch"]
    assert "frames_per_s" in out["metrics"]


def test_run_without_a_card_prints_no_result(tmp_path):
    """No card here: exit non-zero with no result; the same in a directory
    that holds only BENCHMARK.json and the benchmark (no port beside it)."""
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bench_4x4.ls",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=str(REPO), timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bench_4x4.ls",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def _chrome(events):
    return {"traceEvents": [{"ph": "X", **e} for e in events]}


def test_trace_reduce_attributes_by_launch():
    names = ["bench.draws", "bench.simulate", "bench.estimate", "bench.score"]
    marks = [0.0, 10.0, 20.0, 30.0, 40.0]
    ev = [{"cat": "cuda_runtime", "name": "cudaEventRecord", "ts": t, "dur": 1.0, "tid": 1,
           "args": {"correlation": 100 + i}} for i, t in enumerate(marks)]
    launches = [(1, 2.0), (2, 12.0), (3, 22.0), (4, 32.0)]
    ev += [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t, "dur": 1.0, "tid": 1,
            "args": {"correlation": c}} for c, t in launches]
    kernels = [(1, 3.0, 2.0, "void at::native::draw_kernel<float>(float*)"),
               (2, 13.0, 5.0, "sgemm_nn"),
               (3, 23.0, 4.0, "void (anonymous namespace)::hpd_solve_kernel<3, false>(float2*)"),
               (None, 27.0, 1.0, "hpd_solve_kernel<3, false>(float2*)"),  # launch not traced
               (4, 33.0, 6.0, "reduce_kernel")]
    ev += [{"cat": "kernel", "name": n, "ts": t, "dur": d,
            "args": ({"correlation": c} if c else {}) | {"stream": 7}} for c, t, d, n in kernels]
    tr = trace.reduce(_chrome(ev), names, 1)
    assert [op.span for op in tr.ops] == ["bench.draws", "bench.simulate", "bench.estimate",
                                          "bench.estimate", "bench.score"]
    assert tr.unattributed == 1
    assert tr.window_s == pytest.approx(40e-6) and tr.busy_s == pytest.approx(18e-6)
    assert tr.span_seconds("bench.estimate") == pytest.approx(5e-6)
    assert len(trace.kernel_ops(tr, {"hpd_solve_kernel"})) == 2
    assert sum(s for _, s in tr.idle_gaps) == pytest.approx(22e-6)
    assert trace.top_device_ops(tr, 1)[0][0] == "reduce_kernel"
    # an event record of the program's own: the spans are not known
    extra = ev + [{"cat": "cuda_runtime", "name": "cudaEventRecord", "ts": 15.0, "dur": 1.0,
                   "tid": 1, "args": {"correlation": 999}}]
    assert all(op.span is None for op in trace.reduce(_chrome(extra), names, 1).ops)


def test_trace_run_on_the_cpu_reports_no_device_metric():
    out = _run("bench_4x4.ls", trace=True)
    assert out["correct"]
    assert out["metrics"] == {}  # nothing ran on a card: every reader finds nothing
    assert out["device"]["busy_s"] == 0.0


@pytest.mark.cuda
def test_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bench_4x4.ls",
                          "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=str(REPO), timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert {"launches_per_batch", "device_idle", "interp_fused_roofline", "step_mfu"} <= set(
        out["metrics"])
    assert 0 < out["metrics"]["interp_fused_roofline"]["value"] <= 100
