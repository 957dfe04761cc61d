"""The port's command line (``ce5g_torch.cli``) on the CPU.

Every command runs in-process through ``main(argv)`` with ``--device
cpu`` at a small numerology (a 6 × 39 grid, 2×2), from an empty working
directory that must stay empty: each writes only the directories it is
given. Each JSON file a command writes has every key, two levels deep,
of the JAX package's committed file of the same name. The computations
the JAX scripts do inline are held against those scripts' code on the
same inputs: quick_start's three NMSEs and visualize_channels'
autocorrelation on the JAX package's own draws, identifiable_study's
nominal-prior Wiener on a JAX-made split (per sample within 0.01 dB, the
mmse_full tolerance of tests/test_torch_serving.py), diagnose_plateau's
sum oracle and groupings, and final_report's headline on the committed
results/.
"""
import dataclasses
import importlib
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ce5g_torch.cli import MODULES
from ce5g_torch.train import ChannelDataset

from _torch_parity import jax_draws, port_cfg

REPO = Path(__file__).resolve().parent.parent
SMALL_YAML = """\
ofdm: {fft_size: 64, cp_length: 8, num_symbols: 6, useful_subcarriers: 40}
pilots: {density: [0.05, 0.10]}
simulation: {snr_range: [0, 10, 20]}
training: {epochs: 1, batch_size: 8}
compute: {mixed_precision: false}
"""
SIMO_YAML = SMALL_YAML + "mimo: {num_tx_antennas: 1, num_rx_antennas: 2}\n"
MMSE_FULL_DB = 0.01  # tests/test_torch_serving.py's per-sample mmse_full bound
#: the JAX script's flags the port leaves out (none: CE5G_PLATFORM was an
#: environment variable, not a flag)
REMOVED_FLAGS = set()


def _cli(name):
    return importlib.import_module(f"ce5g_torch.cli.{name}")


def _run(name, argv, cwd):
    """``main(argv)`` of one command from ``cwd``; returns its exit code
    and what it left in ``cwd``."""
    old = os.getcwd()
    os.chdir(cwd)
    try:
        rc = _cli(name).main([*argv, "--device", "cpu"])
    finally:
        os.chdir(old)
    return rc, sorted(os.listdir(cwd))


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A small 2×2 split made by generate_dataset (train 16, val 8, test
    16, .ce5g chunks of 8, verified), its 'wiener' and 'bwiener' sidecars
    from compute_wiener, and a cnn trained by train_model (plain, with
    --evaluate, and on the blind sidecars): each run's exit code and what
    it left in its working directory, by command."""
    root = tmp_path_factory.mktemp("cli")
    (root / "small.yaml").write_text(SMALL_YAML)
    (root / "simo.yaml").write_text(SIMO_YAML)
    cfg = ["--config", str(root / "small.yaml")]
    data, models, res = root / "data", root / "models", root / "res"
    runs = {}
    for name, argv in (
        ("generate_dataset", [*cfg, "--output-dir", str(data), "--train-samples", "16",
                              "--val-samples", "8", "--test-samples", "16", "--chunk-size", "8",
                              "--format", "ce5g", "--verify"]),
        ("compute_wiener", [*cfg, "--data-dir", str(data)]),
        ("compute_wiener", [*cfg, "--data-dir", str(data), "--estimator", "mmse_full_est",
                            "--splits", "test", "val", "train"]),
        ("train_model", [*cfg, "--data-dir", str(data), "--model-dir", str(models),
                         "--evaluate", "--results-dir", str(res)]),
        ("train_model", [*cfg, "--data-dir", str(data), "--model-dir", str(models), "--wiener",
                         "--wiener-tag", "bwiener", "--host-staging"]),
    ):
        cwd = root / f"cwd_{len(runs)}"
        cwd.mkdir()
        runs[f"{name}{len(runs)}"] = _run(name, argv, cwd)
    return root, runs


def _jax_flags(name):
    """The flags of scripts/<name>.py (bench.py at the root for 'bench',
    which reads its one flag from sys.argv) and of scripts/_common.py's
    --config, read from their source."""
    path = REPO / "scripts" / f"{name}.py"
    src = (path if path.exists() else REPO / f"{name}.py").read_text()
    return (set(re.findall(r"add_argument\(\s*\"(--[\w-]+)\"", src))
            | set(re.findall(r"\"(--[\w-]+)\" in sys\.argv", src)) | {"--config"})


@pytest.mark.parametrize("name", MODULES)
def test_help_and_flags(name, capsys):
    """--help exits 0, and the flags cover the JAX script's."""
    with pytest.raises(SystemExit) as exc:
        _cli(name).main(["--help"])
    assert exc.value.code == 0
    assert "--device" in capsys.readouterr().out
    flags = set(_cli(name).build_parser()._option_string_actions)
    assert _jax_flags(name) - REMOVED_FLAGS <= flags, _jax_flags(name) - flags


def test_help_as_a_module():
    """``python -m ce5g_torch.cli.<name> --help`` exits 0 in a process of
    its own, with neither JAX nor ce5g_tpu importable."""
    code = ("import sys, runpy; sys.modules['jax'] = None; sys.modules['ce5g_tpu'] = None; "
            "sys.argv = ['quick_start', '--help']; "
            "runpy.run_module('ce5g_torch.cli.quick_start', run_name='__main__')")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "--results-dir" in out.stdout


#: what each command must be given; "{d}" is a directory that must not appear
REQUIRED = {
    "quick_start": ["--results-dir", "{d}"],
    "generate_dataset": ["--output-dir", "{d}"],
    "compute_wiener": ["--data-dir", "{d}"],
    "train_model": ["--model-dir", "{d}"],
    "evaluate_models": ["--results-dir", "{d}"],
    "pilot_optimization": ["--results-dir", "{d}"],
    "tune_hyperparameters": ["--results-dir", "{d}"],
    "apply_tuning": ["--model-dir", "{d}", "--results-dir", "{d}"],
    "final_report": ["--results-dir", "{d}"],
    "train_online": ["--model-dir", "{d}"],
    "generate_at_scale": ["--output-dir", "{d}", "--results-dir", "{d}"],
    "parity_phase2": ["--results-dir", "{d}"],
    "identifiable_study": ["--results-dir", "{d}"],
    "diagnose_plateau": ["--results-dir", "{d}"],
    "visualize_channels": ["--results-dir", "{d}"],
    "bench": [],
    "benchmark_suite": [],
    "bench_factory": ["--results-dir", "{d}"],
    "profile_bench": [],
    "profile_fine": [],
    "profile_solve": [],
}


@pytest.mark.parametrize("name", MODULES)
def test_needs_a_card_or_cpu(name, tmp_path, capsys):
    """Without --device the command runs on the card; with no card it
    raises before it reads or writes anything. The directories it writes
    are required flags."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the rule is for machines without one")
    d = tmp_path / "out"
    argv = [a.format(d=d) for a in REQUIRED[name]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _cli(name).main(argv)
    assert not d.exists()
    for i in range(0, len(argv), 2):
        with pytest.raises(SystemExit) as exc:
            _cli(name).main(argv[:i] + argv[i + 2:])
        assert exc.value.code == 2
        assert argv[i] in capsys.readouterr().err


def test_shard_needs_torchrun(tmp_path, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        _cli("generate_dataset").main(["--output-dir", str(tmp_path / "d"), "--shard",
                                       "--device", "cpu"])


def test_generate_dataset_two_writers(tmp_path):
    """generate_dataset --shard in two processes with torchrun's
    environment (gloo): each rank writes its chunks, rank 0 the global
    manifest, and the split equals one writer's."""
    (tmp_path / "small.yaml").write_text(SMALL_YAML)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    common = ["--config", str(tmp_path / "small.yaml"), "--train-samples", "0",
              "--val-samples", "0", "--test-samples", "24", "--chunk-size", "8",
              "--format", "ce5g", "--device", "cpu"]
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ce5g_torch.cli.generate_dataset", *common, "--shard",
             "--verify", "--output-dir", str(tmp_path / "two")],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "verify test: PASS" in outs[0] and "verify" not in outs[1]
    assert _run("generate_dataset", [*common[:-2], "--output-dir", str(tmp_path / "one")],
                tmp_path)[0] == 0
    two = ChannelDataset(tmp_path / "two" / "test_manifest.json").arrays
    one = ChannelDataset(tmp_path / "one" / "test_manifest.json").arrays
    assert set(two) == set(one)
    for k in one:
        np.testing.assert_array_equal(two[k], one[k])



def test_train_model_two_ranks(ws, tmp_path):
    """train_model --shard --evaluate in two processes with torchrun's
    environment (gloo), against one meshless run, all three on one CPU
    thread and without dropout (the ranks draw their own masks): the
    epochs' losses as tests/test_torch_parallel.py holds Trainer(mesh=)
    (train 1e-5, validation 1e-4 relative); rank 0 alone evaluates, and
    its test NMSE is the meshless run's within 0.01 dB, the bound of that
    file's sharded NMSE. The NMSE moves more than the losses (0.003 dB
    here): the conv biases ahead of BatchNorm get only rounding for a
    gradient, which Adam scales to whole steps, and the running means
    carry that into eval mode."""
    root, _ = ws
    (tmp_path / "shard.yaml").write_text(SMALL_YAML + "model: {cnn: {dropout: 0.0}}\n")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}

    def start(name, extra, extra_env):
        return subprocess.Popen(
            [sys.executable, "-m", "ce5g_torch.cli.train_model", "--config",
             str(tmp_path / "shard.yaml"), "--data-dir", str(root / "data"), "--model-dir",
             str(tmp_path / f"models_{name}"), "--evaluate", "--results-dir",
             str(tmp_path / f"res_{name}"), "--device", "cpu", *extra],
            cwd=tmp_path, env={**env, **extra_env}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    procs = [start("two", ["--shard"], {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
                                        "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
             for r in range(2)]
    procs.append(start("one", [], {}))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert "'nmse_db'" in outs[0] and "'nmse_db'" not in outs[1]
    two, one = (json.loads((tmp_path / f"models_{n}" / "cnn_history.json").read_text())
                for n in ("two", "one"))
    np.testing.assert_allclose(two["train_loss"], one["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(two["val_loss"], one["val_loss"], rtol=1e-4)
    two, one = (json.loads((tmp_path / f"res_{n}" / "cnn_test_results.json").read_text())
                for n in ("two", "one"))
    assert abs(two["nmse_db"] - one["nmse_db"]) <= 0.01
    assert sorted(os.listdir(tmp_path)) == ["models_one", "models_two", "res_one", "res_two",
                                            "shard.yaml"]

#: the measuring tools, run small by tests/test_torch_bench.py
MEASURING = ("bench", "benchmark_suite", "bench_factory", "profile_bench", "profile_fine",
             "profile_solve")


def _assert_keys(got, ref, depth, path=""):
    """Every key of ``ref`` is in ``got``, for ``depth`` levels of dicts."""
    missing = set(ref) - set(got)
    assert not missing, f"{path or 'top level'} lacks {sorted(missing)}"
    if depth > 1:
        for k, v in ref.items():
            if isinstance(v, dict) and isinstance(got[k], dict):
                _assert_keys(got[k], v, depth - 1, f"{path}/{k}")


def _committed(rel):
    return json.loads((REPO / rel).read_text())


def _runs(root):
    """The commands of the run test, by name: (argv, {written file: the
    JAX file whose keys it has, and to what depth})."""
    cfg = ["--config", str(root / "small.yaml")]
    data, models, res = str(root / "data"), str(root / "models"), str(root / "res")
    return {
        "quick_start": ([*cfg, "--no-plots", "--results-dir", res], {}),
        "evaluate_models": (
            [*cfg, "--data-dir", data, "--model-dir", str(REPO / "models"), "--results-dir", res,
             "--models", "cnn", "resnet", "lstm", "hybrid", "cnn_wiener", "transformer",
             "--snr-sweep", "--no-plots"],
            {"evaluation_results.json": ("results/evaluation_results.json", 2),
             "snr_sweep_results.json": ("results/snr_sweep_results.json", 1)}),
        "pilot_optimization": (
            [*cfg, "--results-dir", res, "--frames", "2", "--densities", "0.05", "0.1",
             "--model-densities", "0.05", "--snrs", "10", "--models", "cnn", "cnn_wiener",
             "--model-dir", str(REPO / "models"), "--data-dir", data,
             "--simo-ber-config", str(root / "simo.yaml"), "--ber-frames", "2"],
            {"pilot_optimization_results.json": ("results/pilot_optimization_results.json", 2)}),
        "train_online": (
            [*cfg, "--model-dir", models, "--samples", "8", "--batch", "4",
             "--steps-per-dispatch", "1", "--stats-from", data, "--bf16"], {}),
        "generate_at_scale": (
            [*cfg, "--output-dir", str(root / "atscale"), "--results-dir", res, "--samples", "16",
             "--chunk-size", "8", "--online-samples", "8", "--online-batch", "4",
             "--steps-per-dispatch", "1", "--codec-chunk", "4"],
            {"at_scale_generation.json": ("results/at_scale_generation.json", 2)}),
        "parity_phase2": ([*cfg, "--results-dir", res, "--frames", "1"],
                          {"parity_phase2.json": ("results/parity_phase2.json", 2)}),
        "identifiable_study": (
            [*cfg, "--data-dir", data, "--model-dir", str(REPO / "models_simo"),
             "--results-dir", res, "--models", "cnn", "cnn_wiener", "cnn_wiener_blind",
             "cnn_wiener_blind_online", "resnet", "transformer", "hybrid"],
            {"identifiable_study.json": ("results_simo/identifiable_study.json", 2)}),
        "diagnose_plateau": (
            [*cfg, "--data-dir", data, "--model-dir", str(REPO / "models"), "--results-dir", res,
             "--models", "cnn", "resnet", "cnn_wiener"],
            {"plateau_diagnosis.json": ("results/plateau_diagnosis.json", 2)}),
        "visualize_channels": ([*cfg, "--results-dir", res, "--no-plots"], {}),
    }


@pytest.mark.parametrize("name", [m for m in MODULES if m not in
                                  ("generate_dataset", "compute_wiener", "train_model",
                                   "tune_hyperparameters", "apply_tuning", "final_report")
                                  and m not in MEASURING])
def test_cli_runs(ws, name, tmp_path):
    """One run of the command, from an empty working directory that it
    leaves empty, and the keys of each JSON file it writes."""
    root, _ = ws
    argv, files = _runs(root)[name]
    assert _run(name, argv, tmp_path) == (0, [])
    for written, (committed, depth) in files.items():
        _assert_keys(json.loads((root / "res" / written).read_text()), _committed(committed),
                     depth)


def test_factory_and_training_runs(ws):
    """generate_dataset, compute_wiener (both tags) and train_model (plain
    with --evaluate; 'bwiener' with host staging), run by the fixture:
    each exited 0 and left its working directory empty; the history and
    test results have the JAX files' keys."""
    root, runs = ws
    assert all(r == (0, []) for r in runs.values()), runs
    assert {p.name for p in (root / "data").glob("*_manifest.json")} == {
        f"{s}{t}_manifest.json" for s in ("train", "val", "test")
        for t in ("", "_wiener", "_bwiener")}
    _assert_keys(json.loads((root / "models" / "cnn_history.json").read_text()),
                 _committed("models/cnn_history.json"), 1)
    _assert_keys(json.loads((root / "res" / "cnn_test_results.json").read_text()),
                 _committed("results/cnn_test_results.json"), 1)
    assert (root / "models" / "cnn_wiener_blind_best").is_dir()


def test_apply_tuning_and_final_report(ws, tmp_path):
    """The search's winner retrained and evaluated as cnn_tuned, then the
    final report over the results: no TPU throughput or roofline."""
    root, _ = ws
    cfg = ["--config", str(root / "small.yaml")]
    res = root / "res_tuning"
    assert _run("tune_hyperparameters", [*cfg, "--data-dir", str(root / "data"),
                                         "--results-dir", str(res), "--trials", "1",
                                         "--epochs", "1", "--quick-train", "8",
                                         "--quick-val", "4"], tmp_path) == (0, [])
    assert _run("apply_tuning", [*cfg, "--data-dir", str(root / "data"), "--model-dir",
                                 str(root / "models_tuned"), "--results-dir", str(res),
                                 "--epochs", "1"], tmp_path) == (0, [])
    r = json.loads((res / "cnn_tuned_test_results.json").read_text())
    _assert_keys(r, _committed("results/cnn_test_results.json"), 1)
    search = json.loads((res / "random_search_results.json").read_text())
    assert r["tuning_winner"] == search[0]["params"]
    assert _run("final_report", [*cfg, "--results-dir", str(res), "--model-dir",
                                 str(root / "models_tuned"), "--study-dir", str(res),
                                 "--no-plots"], tmp_path) == (0, [])
    text = (res / "FINAL_REPORT.md").read_text()
    assert "| cnn_tuned |" in text and "## random_search_results" in text
    assert "Throughput" not in text and "Roofline" not in text and "BENCH_r" not in text


def test_parity_markdown(ws):
    """parity_phase2.md has the JAX script's tables (written by the run
    test's parity_phase2, or here if that has not run)."""
    root, _ = ws
    md = root / "res" / "parity_phase2.md"
    if not md.exists():
        assert _run("parity_phase2", _runs(root)["parity_phase2"][0], root)[0] == 0
    text = md.read_text()
    for head in ("# Phase-2 classical-estimator parity", "## LS vs MMSE", "## Interpolation study",
                 "## scipy.griddata cross-check"):
        assert head in text
    assert text.count("| nearest |") == 2 and "/12 |" in text


# --------------------------------------------- the inline computations vs the JAX scripts


def _import_script(name):
    """scripts/<name>.py, imported with scripts/ on sys.path. Its
    _common sets a persistent XLA compile cache; the test puts JAX's
    cache settings back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(REPO / "scripts"))
        for k, v in saved.items():
            jax.config.update(k, v)


@pytest.fixture(scope="module")
def small_jcfg():
    from ce5g_tpu import ExperimentConfig, MIMOConfig, OFDMConfig

    return ExperimentConfig(
        ofdm=OFDMConfig(fft_size=64, cp_length=8, num_symbols=6, useful_subcarriers=40),
        mimo=MIMOConfig(num_tx=2, num_rx=2),
    )


def _one(draws):
    return type(draws)(*(x[0] for x in draws))


def test_quick_start_matches_jax(small_jcfg):
    """The three NMSEs of scripts/quick_start.py's frame (key(cfg.seed),
    EVA, 50 Hz, 15 dB, 10%) on the JAX package's draws, within 0.01 dB."""
    import functools

    import jax.numpy as jnp
    from ce5g_tpu.estimators import estimate_frame
    from ce5g_tpu.physics import PROFILE_INDEX, FrameParams, simulate_frame, table_for
    from ce5g_tpu.utils import evaluate_estimator

    from ce5g_torch.cli import quick_start

    jcfg = small_jcfg
    key = jax.random.key(jcfg.seed)
    params = FrameParams(jnp.int32(PROFILE_INDEX["EVA"]), jnp.float32(50.0), jnp.float32(15.0),
                         jnp.float32(0.1))
    table = table_for(jcfg)
    frame = jax.jit(functools.partial(simulate_frame, cfg=jcfg, table=table))(key, params)
    ref = {est: float(evaluate_estimator(frame.channel, jax.jit(functools.partial(
        estimate_frame, cfg=jcfg, estimator=est, table=table))(frame))["nmse_db"])
        for est, _ in quick_start.ESTIMATORS}

    cfg = port_cfg(jcfg)
    tframe = quick_start.simulate(cfg, "EVA", 50.0, 15.0, 0.1, torch.device("cpu"),
                                  draws=_one(jax_draws(key[None], jcfg)))
    got = quick_start.estimates(tframe, cfg, torch.device("cpu"))
    for (est, label) in quick_start.ESTIMATORS:
        assert abs(got[label][1] - ref[est]) < 0.01, (label, got[label][1], ref[est])


def test_autocorrelation_matches_jax(small_jcfg):
    """visualize_channels' autocorrelation of EVA at each Doppler over the
    50-symbol frame, on the JAX package's draws (every frame keyed
    key(cfg.seed), as the JAX script keys them), against the script's
    loop on the JAX package's frames, within 1e-5."""
    import functools

    import jax.numpy as jnp
    from ce5g_tpu.physics import PROFILE_INDEX, FrameParams, simulate_frame, table_for

    from ce5g_torch.cli import visualize_channels as vc

    snr = 20.0
    key = jax.random.key(small_jcfg.seed)
    ext = dataclasses.replace(small_jcfg, ofdm=dataclasses.replace(small_jcfg.ofdm,
                                                                   num_symbols=50))
    got = vc.channel_arrays(port_cfg(small_jcfg), snr, torch.device("cpu"),
                            draws_for=lambda c: _one(jax_draws(key[None], c)))
    assert set(got["autocorrelation"]) == {float(fd) for fd in small_jcfg.channel.doppler_hz}
    sim = jax.jit(functools.partial(simulate_frame, cfg=ext, table=table_for(ext)))
    for fd in small_jcfg.channel.doppler_hz:
        p = FrameParams(jnp.int32(PROFILE_INDEX["EVA"]), jnp.float32(fd), jnp.float32(snr),
                        jnp.float32(0.1))
        h = np.asarray(sim(key, p).channel)[:, 0, 0, :]
        ac = []
        for lag in range(25):  # scripts/visualize_channels.py:97-101
            a = h[: 50 - lag]
            b = h[lag:]
            ac.append(np.abs(np.mean(a * np.conj(b))) / np.mean(np.abs(h) ** 2))
        np.testing.assert_allclose(got["autocorrelation"][float(fd)], ac, atol=1e-5, rtol=0)
        assert got["doppler"][float(fd)].shape == (6, 39)
    assert set(got["heatmaps"]) == {"EPA", "EVA", "ETU"}


@pytest.fixture(scope="module")
def jax_simo_split(tmp_path_factory):
    """Six 1×2 SIMO frames made by the JAX package (generate_chunk_fn) as a
    merged npz split, and the JAX config."""
    from ce5g_tpu import (ExperimentConfig, MIMOConfig, OFDMConfig, PilotConfig,
                          SimulationConfig)
    from ce5g_tpu.data.generator import generate_chunk_fn

    jcfg = ExperimentConfig(
        ofdm=OFDMConfig(fft_size=64, cp_length=8, num_symbols=6, useful_subcarriers=40),
        mimo=MIMOConfig(num_tx=1, num_rx=2),
        pilots=PilotConfig(density=(0.05, 0.10), max_density=0.15),
        simulation=SimulationConfig(snr_range_db=(0.0, 10.0, 20.0)),
    )
    root = tmp_path_factory.mktemp("jax_simo")
    keys = jax.random.split(jax.random.key(11), 6)
    np.savez(root / "test.npz", **{k: np.asarray(v)
                                   for k, v in generate_chunk_fn(jcfg)(keys).items()})
    return root / "test.npz", jcfg


def test_blind_wiener_matches_jax(jax_simo_split):
    """identifiable_study's mmse_full with the nominal priors (EVA /
    100 Hz / 15 dB), in batches of 4 over 6 frames (the last realigned),
    per sample within 0.01 dB of scripts/identifiable_study.py's."""
    from ce5g_tpu.train import ChannelDataset as JChannelDataset

    from ce5g_torch.cli import identifiable_study

    path, jcfg = jax_simo_split
    script = _import_script("identifiable_study")
    ref, _ = script.evaluate_blind_wiener(JChannelDataset(str(path)), jcfg, None, batch_size=4)
    got, lat = identifiable_study.evaluate_blind_wiener(ChannelDataset(path), port_cfg(jcfg),
                                                        None, batch_size=4, device="cpu")
    assert got.shape == ref.shape == (6,) and lat > 0
    db = 10 * np.log10(got / ref)
    assert np.max(np.abs(db)) < MMSE_FULL_DB, db
    snr = np.asarray(ChannelDataset(path).arrays["snr_db"])
    assert identifiable_study.group_db(got, snr).keys() == script._group_db(ref, snr).keys()


def test_plateau_oracle_and_groupings_match_jax(ws):
    """diagnose_plateau's sum oracle (full tensor and slice) and its
    groupings by SNR, channel type, density and Doppler, on the fixture's
    split, against scripts/diagnose_plateau.py's code to 1e-6 dB; the
    channel types named from profile_idx where a split holds no
    channel_type."""
    from ce5g_tpu.eval.evaluate import _nmse_per_sample as j_nmse
    from ce5g_tpu.train import ChannelDataset as JChannelDataset

    from ce5g_torch.cli import diagnose_plateau as dp

    root, _ = ws
    script = _import_script("diagnose_plateau")
    arrays = JChannelDataset(str(root / "data" / "test_manifest.json")).arrays
    h = arrays["H_true"]
    n = len(h)
    # scripts/diagnose_plateau.py:78-81 and :116
    ref_full = j_nmse(h, np.broadcast_to(h.mean(axis=3, keepdims=True), h.shape))
    ref_slice = j_nmse(h[:, :, 0, 0, :], h.mean(axis=3)[:, :, 0, :])
    got = dp.sum_oracle(ChannelDataset(root / "data" / "test_manifest.json").arrays["H_true"])
    np.testing.assert_allclose(10 * np.log10(got["full"]), 10 * np.log10(ref_full), atol=1e-6)
    np.testing.assert_allclose(10 * np.log10(got["slice00"]), 10 * np.log10(ref_slice),
                               atol=1e-6)
    ctype = dp.channel_types(arrays, n)
    by_index = {k: v for k, v in arrays.items() if k != "channel_type"}
    by_index["profile_idx"] = np.asarray(
        [["EPA", "EVA", "ETU"].index(str(c)) for c in arrays["channel_type"]], np.int32)
    np.testing.assert_array_equal(dp.channel_types(by_index, n), ctype)
    for key in (arrays["snr_db"], arrays["channel_type"], arrays["pilot_density"],
                arrays["doppler_hz"]):
        ref = script._group(ref_full, key)
        mine = dp.group(got["full"], ctype if key is arrays["channel_type"] else key)
        assert mine.keys() == ref.keys()
        for k in ref:
            assert abs(mine[k] - ref[k]) < 1e-6
    assert set(dp.group(got["full"], ctype)) <= {"EPA", "EVA", "ETU"}


def test_headline_matches_jax(monkeypatch, tmp_path):
    """final_report's headline on the committed results/ is the JAX
    script's text without its throughput line and roofline section: their
    inputs there (BENCH_r*.json, results/benchmark_suite.json) are TPU
    files that name no card. With a port-made bench.json and
    benchmark_suite.json the two parts come back, with the card's name;
    a BENCH_r*.json in the working directory is never read."""
    from ce5g_torch.cli import final_report

    monkeypatch.chdir(REPO)
    script = _import_script("final_report")
    ref = script.build_headline(REPO / "results", REPO / "models")
    lines = ref.split("\n")
    lines = [ln for ln in lines if not ln.startswith("- **Throughput**")]
    if "### Roofline (train steps)" in lines:
        cut = lines.index("### Roofline (train steps)")
        lines = lines[:cut - 1]  # the section and the blank line before it
    got = final_report.build_headline(REPO / "results", REPO / "models", REPO / "results_simo")
    assert got == "\n".join(lines)
    assert "Throughput" in ref and "Roofline" in ref  # the two parts the port leaves out

    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    res = tmp_path / "res"
    res.mkdir()
    (res / "bench.json").write_text(json.dumps(
        {"metric": "m", "value": 1234.5, "unit": "frames/s", "card": card}))
    (res / "benchmark_suite.json").write_text(json.dumps(
        {"card": card, "simulate": {"ms_per_batch": 1.0},
         "train_step_cnn/b64/bf16": {"ms_per_step": 21.25, "mfu": 0.031},
         "train_step_cnn/b64/f32": {"error": "out of memory"}}))
    work = tmp_path / "cwd"
    work.mkdir()
    (work / "BENCH_r09.json").write_text(json.dumps({"value": 999999.0, "unit": "frames/s"}))
    monkeypatch.chdir(work)
    got = final_report.build_headline(res, REPO / "models", res)
    assert got.split("\n")[0] == f"- **Throughput**: 1234 frames/s on one card ({card}; bench.json)."
    assert f"### Roofline (train steps; {card})" in got
    assert "- `train_step_cnn/b64/bf16`: 21.2 ms/step, MFU 3.1%" in got
    assert "b64/f32" not in got and "999999" not in got and "BENCH_r" not in got
    for name in ("bench.json", "benchmark_suite.json"):  # a file without a card is not read
        d = json.loads((res / name).read_text())
        del d["card"]
        (res / name).write_text(json.dumps(d))
    assert final_report.build_headline(res, REPO / "models", res) == ""
