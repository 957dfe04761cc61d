"""Port parity of the studies: the pilot-density sweep and its model
column, the hyperparameter search and the reports, ce5g_torch against
ce5g_tpu on the same inputs on the CPU.

Each study's cell i is fed the JAX package's own draws of key(seed + i)
(``PilotOptimizer.draws`` / ``qam_draws`` replaced), so both packages
score the same frames. Tolerances: a cell's NMSE within 0.01 dB (the
estimators agree within 1e-3 of the rms, tests/test_torch_estimators.py;
the models within 1e-4, tests/test_torch_models.py); a cell's BER within
5e-4 (decision-boundary flips, tests/test_torch_ber.py); the tuner's
trials and quick datasets exactly; report text exactly but for the title
and "Generated" lines.
"""
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_draws, jax_qam_draws, port_cfg

REPO = pathlib.Path(__file__).resolve().parents[1]


def _two_by_two():
    from ce5g_tpu import ExperimentConfig, MIMOConfig

    return ExperimentConfig(mimo=MIMOConfig(num_tx=2, num_rx=2))


def test_sweep_matches_jax(tmp_path):
    from ce5g_tpu.eval import PilotOptimizer as JPilotOptimizer
    from ce5g_torch.eval import PilotOptimizer

    jcfg = _two_by_two()
    kw = dict(densities=(0.05, 0.15), snrs_db=(10.0,), estimators=("mmse", "mmse_full"),
              frames_per_cell=2, seed=4)
    want = JPilotOptimizer(jcfg, str(tmp_path / "jax")).sweep(**kw)
    opt = PilotOptimizer(port_cfg(jcfg), str(tmp_path / "port"), device="cpu")
    opt.draws = lambda index, params: jax_draws(
        jax.random.split(jax.random.key(index), params.profile_idx.shape[0]), jcfg)
    got = opt.sweep(**kw, per_frame=True)
    for est, by_d in got.pop("per_frame").items():  # each cell's per-frame means
        for d, by_s in by_d.items():
            for s, cell in by_s.items():
                assert len(cell["err"]) == len(cell["pwr"]) == 2
                ratio = np.mean(cell["err"]) / np.mean(cell["pwr"])
                assert 10 * np.log10(ratio) == pytest.approx(got["results"][est][d][s], abs=1e-4)
    assert got["config"] == want["config"]
    for est, rows in want["results"].items():
        for d, row in rows.items():
            for s, db in row.items():
                assert got["results"][est][d][s] == pytest.approx(db, abs=0.01), (est, d, s)
        rec = got["recommendation"][est]
        assert rec["best_density"] == want["recommendation"][est]["best_density"]
        assert rec["avg_nmse_db"] == pytest.approx(want["recommendation"][est]["avg_nmse_db"],
                                                   abs=0.01)
    path = opt.save(got)
    assert json.loads(path.read_text()) == got


def _stats(keys, jcfg):
    """Normalisers of a small shared split: the std of |·| over the first
    antenna pair, as ChannelDataset computes them."""
    from ce5g_tpu.estimators.api import estimate_batch
    from ce5g_tpu.physics import FrameParams, simulate_batch

    b = keys.shape[0]
    params = FrameParams(*(np.full(b, v, dt) for v, dt in (
        (1, np.int32), (50.0, np.float32), (10.0, np.float32), (0.05, np.float32))))
    frames = jax.jit(lambda k, p: simulate_batch(k, p, cfg=jcfg))(keys, params)
    h_ls = jax.jit(lambda f: estimate_batch(f, cfg=jcfg, estimator="ls"))(frames)
    return {"rx_std": float(np.std(np.abs(frames.rx_symbols[:, :, 0])) + 1e-8),
            "hls_std": float(np.std(np.abs(h_ls[:, :, 0, 0])) + 1e-8),
            "h_std": float(np.std(np.abs(frames.channel[:, :, 0, 0])) + 1e-8)}


def test_model_sweep_matches_jax(tmp_path):
    """The committed models/cnn_best and cnn_wiener_best next to
    'mmse_full', one density and SNR, two frames (a checkpoint missing from
    the directory is left out)."""
    from ce5g_tpu.eval import PilotOptimizer as JPilotOptimizer
    from ce5g_torch.eval import PilotOptimizer

    jcfg = _two_by_two()
    stats = _stats(jax.random.split(jax.random.key(99), 4), jcfg)
    kw = dict(model_types=("cnn", "cnn_wiener", "resnet_missing"),
              model_dir=str(REPO / "models"), stats=stats, densities=(0.05,),
              snrs_db=(10.0,), estimators=("mmse_full",), frames_per_cell=2, seed=7)
    want = JPilotOptimizer(jcfg, str(tmp_path / "jax")).model_sweep(**kw)
    opt = PilotOptimizer(port_cfg(jcfg), device="cpu")
    opt.qam_draws = lambda index, params, modulation: jax_qam_draws(
        jax.random.split(jax.random.key(index), params.profile_idx.shape[0]), jcfg, modulation)
    got = opt.model_sweep(**kw, per_frame=True)
    assert got["config"] == want["config"] and got["config"]["models"] == ["cnn", "cnn_wiener"]
    for name, by_d in got["results"].items():  # each cell's per-sample NMSE
        cell = by_d["0.05"]["10.0"]
        assert 10 * np.log10(np.mean(cell.pop("per_sample_nmse"))) == pytest.approx(
            cell["nmse_db_slice"], abs=1e-4)
    assert got["basis"] == want["basis"]
    assert set(got["results"]) == {"mmse_full", "cnn", "cnn_wiener"}
    for name, by_d in want["results"].items():
        for d, row in by_d.items():
            for s, cell in row.items():
                mine = got["results"][name][d][s]
                assert mine["nmse_db_slice"] == pytest.approx(cell["nmse_db_slice"], abs=0.01)
                assert mine["ber"] == pytest.approx(cell["ber"], abs=5e-4), (name, d, s)
    for name, rec in want["recommendation"].items():
        assert got["recommendation"][name]["best_density"] == rec["best_density"]
    with pytest.raises(ValueError, match="no results_dir"):
        opt.save(got)


class _Base:
    """The fields of a ChannelDataset that QuickDataset reads."""

    def __init__(self, n):
        rng = np.random.default_rng(n)
        self.arrays = {"a": np.arange(n), "b": rng.standard_normal((n, 3)).astype(np.float32)}
        self.normalize, self.stats, self.wiener = True, {"h_std": 2.0}, False

    def __len__(self):
        return len(self.arrays["a"])


@pytest.mark.parametrize("n,keep,seed", [(37, 10, 42), (2000, 500, 0), (12, 20, 3)])
def test_quick_dataset_matches_jax(n, keep, seed):
    from ce5g_tpu.eval import QuickDataset as JQuickDataset
    from ce5g_torch.eval import QuickDataset

    got, want = QuickDataset(_Base(n), keep, seed), JQuickDataset(_Base(n), keep, seed)
    assert set(got.arrays) == set(want.arrays)
    for key in want.arrays:
        np.testing.assert_array_equal(got.arrays[key], want.arrays[key])
    assert got.stats == want.stats and (got.normalize, got.wiener) == (True, False)


def _trials_of(tuner, monkeypatch, tmp_path):
    """The trials ``tuner.random_search(20, seed=0)`` draws, with each
    trial's training replaced by its draw index as the loss."""
    seen = []

    def fake(self, trial, *_):
        seen.append(trial)
        return {"params": trial, "val_loss": float(len(seen))}

    monkeypatch.setattr(type(tuner), "_run_trial", fake)
    results = tuner.random_search(num_trials=20, seed=0)
    assert [r["val_loss"] for r in results] == list(range(1, 21))
    assert json.loads((tmp_path / "random_search_results.json").read_text()) == json.loads(
        json.dumps(results, default=str))
    return seen


def test_random_search_draws_the_jax_trials(monkeypatch, tmp_path):
    """The 20 trials of random_search(seed=0) equal the JAX tuner's in the
    order drawn, and are the 20 of results_simo/random_search_results.json,
    whose first three drawn trials read validation losses 0.3796, 0.3260
    and 0.2839."""
    from ce5g_tpu.eval import HyperparameterTuner as JTuner
    from ce5g_torch.eval import DEFAULT_CNN_SPACE, HyperparameterTuner
    from ce5g_torch.eval.tuning import draw_random_trials

    jcfg = _two_by_two()
    want = _trials_of(JTuner(jcfg, _Base(40), _Base(20), str(tmp_path / "jax"), log=print),
                      monkeypatch, tmp_path / "jax")
    tuner = HyperparameterTuner(port_cfg(jcfg), _Base(40), _Base(20), str(tmp_path / "port"),
                                log=print, device="cpu")
    got = _trials_of(tuner, monkeypatch, tmp_path / "port")
    assert got == want and draw_random_trials(20) == want
    assert list(got[0]) == list(DEFAULT_CNN_SPACE)

    stored = json.loads((REPO / "results_simo" / "random_search_results.json").read_text())
    as_json = [json.loads(json.dumps(t)) for t in got]
    assert sorted(map(json.dumps, as_json)) == sorted(json.dumps(r["params"]) for r in stored)
    loss = {json.dumps(r["params"]): r["val_loss"] for r in stored}
    first = [loss[json.dumps(t)] for t in as_json[:3]]
    assert first == pytest.approx([0.3796, 0.3260, 0.2839], abs=1e-4)


def test_apply_trial_matches_jax():
    from ce5g_tpu.eval.tuning import _apply_trial as j_apply
    from ce5g_torch.eval.tuning import _apply_trial, draw_random_trials

    jcfg = _two_by_two()
    for trial in draw_random_trials(3) + [{}]:
        want = j_apply(jcfg, trial, 5)
        assert _apply_trial(port_cfg(jcfg), trial, 5) == port_cfg(want)


def test_a_tiny_trial_end_to_end(tmp_path):
    """One random and two grid trials on a factory split of the small
    numerology, on the CPU: sorted results with finite losses, written."""
    from ce5g_torch import ExperimentConfig, MIMOConfig, OFDMConfig
    from ce5g_torch.data import DatasetGenerator
    from ce5g_torch.eval import HyperparameterTuner
    from ce5g_torch.train import ChannelDataset

    cfg = ExperimentConfig(
        ofdm=OFDMConfig(fft_size=64, cp_length=8, num_symbols=6, useful_subcarriers=40),
        mimo=MIMOConfig(num_tx=1, num_rx=2))
    gen = DatasetGenerator(cfg, str(tmp_path / "data"), device="cpu")
    paths = {}
    for split, n in (("train", 24), ("val", 12)):
        gen.generate_split(split, n, log=lambda *_: None)
        paths[split] = str(tmp_path / "data" / f"{split}_manifest.json")
    tuner = HyperparameterTuner(cfg, ChannelDataset(paths["train"]), ChannelDataset(paths["val"]),
                                str(tmp_path / "results"), quick_train=16, quick_val=8,
                                epochs_per_trial=1, log=lambda *_: None, device="cpu")
    assert len(tuner.train_ds) == 16 and tuner.train_ds.stats == ChannelDataset(
        paths["train"]).stats
    space = {"learning_rate": [1e-3], "batch_size": [4], "hidden_channels": [(8, 8), (4,)],
             "dropout": (0.0, 0.2)}
    rand = tuner.random_search(num_trials=1, space=space)
    grid = tuner.grid_search(space={"batch_size": [4], "hidden_channels": [(8,), (4, 4)]},
                             max_trials=2)
    for results, name in ((rand, "random"), (grid, "grid")):
        losses = [r["val_loss"] for r in results]
        assert all(np.isfinite(losses)) and losses == sorted(losses)
        stored = json.loads((tmp_path / "results" / f"{name}_search_results.json").read_text())
        assert [r["val_loss"] for r in stored] == losses
    assert 0.0 <= rand[0]["params"]["dropout"] <= 0.2


def _report_results():
    return {
        "ls": {"nmse_db": 0.41, "nmse_db_slice": 1.2, "mse": 1.1e-1,
               "latency_ms_per_sample": 0.02, "source": "estimator re-run"},
        "mmse_full": {"nmse_db": -3.0, "nmse_db_slice": -2.4, "mse": 5e-2,
                      "latency_ms_per_sample": 0.05},
        "cnn": {"nmse_db": -2.2, "mse": 6e-2, "basis": "slice (rx0, tx0)", "params": 123},
        "num_samples": 64,
    }


def _body(text):
    return [line for line in text.splitlines()
            if not line.startswith(("Generated:", "# Final Report"))]


def test_reports_read_as_the_jax_package_s(tmp_path):
    from ce5g_tpu.eval import report as jreport
    from ce5g_torch.eval import report

    results = _report_results()
    summary = {"config": "2x2", "frames": 64}
    got = report.generate_evaluation_report(results, str(tmp_path / "a.md"), summary)
    want = jreport.generate_evaluation_report(results, str(tmp_path / "b.md"), summary)
    assert _body(got) == _body(want) and got != ""
    assert (tmp_path / "a.md").read_text() == got

    rd = tmp_path / "final"
    rd.mkdir()
    (rd / "pilot_optimization_results.json").write_text(json.dumps({"recommendation": {}}))
    (rd / "broken.json").write_text("{")
    kw = dict(extra_sections={"Notes": "n"}, lead_sections={"Summary": "s"})
    got = report.generate_final_report(str(rd), "PORT.md", **kw)
    want = jreport.generate_final_report(str(rd), "JAX.md", **kw)
    assert _body(got) == _body(want)
    assert got.splitlines()[0] == "# Final Report — 5G Channel Estimation, PyTorch/CUDA port (ce5g_torch)"
    assert (rd / "PORT.md").read_text() == got


def test_plots_are_written(tmp_path):
    pytest.importorskip("matplotlib")
    from ce5g_torch.eval import plot_comparison, plot_snr_sweep, plot_training_curves

    outs = [
        plot_comparison(_report_results() | {"num_samples": {}}, str(tmp_path / "cmp.png")),
        plot_snr_sweep({"ls": {"5.0": {"nmse_db": 1.0}, "10.0": {"nmse_db": 0.5}}},
                       str(tmp_path / "snr.png")),
        plot_training_curves({"cnn": {"train_loss": [1.0, 0.5], "val_loss": [1.1, 0.6]}},
                             str(tmp_path / "train.png")),
    ]
    for out in outs:
        assert pathlib.Path(out).stat().st_size > 1000


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_study_entry_points_default_to_the_card():
    from ce5g_torch.eval import HyperparameterTuner, PilotOptimizer

    cfg = port_cfg(_two_by_two())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PilotOptimizer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HyperparameterTuner(cfg, _Base(4), _Base(4), "/nonexistent/never-written")


@pytest.mark.slow  # ≈1 h: the JAX package trains this cnn at ≈20 s a step on the CPU
def test_first_tuner_trial_matches_jax(tmp_path):
    """The first trial of the SIMO random search (seed 0: kernel 3, channels
    64-128-64, batch 64, lr 1e-3) on one port-made SIMO split of 2000 / 500
    frames (so the tuner's quick datasets are the whole split), 5 epochs,
    trained by both packages in float32 on the CPU, each from its own
    initialisation and dropout draws. The grid is cut to 6 × 39: at the
    full 14 × 599 the JAX package takes minutes a step of 64 frames on the
    CPU. ``pytest tests/test_torch_studies.py -m slow -s`` prints both
    validation curves. From epoch 2 on, each epoch's loss lies within 5% of
    the JAX package's, and the trial's result (its best loss) within 2%;
    the first epoch's differs with the initial weights (measured: 0.6287
    against 0.8277, then 2.8% at most, the best 0.14% apart). chip_smoke's
    phase 14 holds the card's trials to the JAX study's, trained on a TPU
    (bf16) on the JAX package's split."""
    import chip_smoke
    from ce5g_tpu.config import load_config
    from ce5g_tpu.eval.tuning import _apply_trial as j_apply_trial
    from ce5g_tpu.train import ChannelDataset as JDataset
    from ce5g_tpu.train import Trainer as JTrainer
    from ce5g_torch.data import DatasetGenerator
    from ce5g_torch.eval.tuning import _apply_trial, draw_random_trials
    from ce5g_torch.train import ChannelDataset, Trainer

    jcfg = load_config(str(REPO / "configs" / "simo_identifiable.yaml"))
    jcfg = dataclasses.replace(
        jcfg, training=dataclasses.replace(jcfg.training, mixed_precision=False),
        ofdm=dataclasses.replace(jcfg.ofdm, fft_size=64, cp_length=8, num_symbols=6,
                                 useful_subcarriers=40))
    cfg = port_cfg(jcfg)
    gen = DatasetGenerator(cfg, str(tmp_path), device="cpu")
    paths = {}
    for split, n in (("train", chip_smoke.TUNE_TRAIN), ("val", chip_smoke.TUNE_VAL)):
        gen.generate_split(split, n, log=lambda *_: None)
        paths[split] = str(tmp_path / f"{split}_manifest.json")
    trial = draw_random_trials(1)[0]
    epochs = chip_smoke.TUNE_EPOCHS
    torch.manual_seed(0)
    port = Trainer(_apply_trial(cfg, trial, epochs), model_type="cnn", log=lambda *_: None,
                   device="cpu").train(ChannelDataset(paths["train"]), ChannelDataset(paths["val"]),
                                       epochs=epochs, model_dir=str(tmp_path / "port"))
    jax_run = JTrainer(j_apply_trial(jcfg, trial, epochs), model_type="cnn",
                       log=lambda *_: None).train(
        JDataset(paths["train"]), JDataset(paths["val"]), epochs=epochs,
        model_dir=str(tmp_path / "jax"))
    curves = {"port": port["history"]["val_loss"], "jax": jax_run["history"]["val_loss"]}
    print(f"\nfirst tuner trial {trial}, validation loss by epoch: "
          + "; ".join(f"{k} " + " ".join(f"{v:.4f}" for v in c) for k, c in curves.items()))
    assert len(curves["port"]) == len(curves["jax"]) == epochs
    for got, want in zip(curves["port"][1:], curves["jax"][1:]):
        assert got == pytest.approx(want, rel=0.05)
    assert port["best_val_loss"] == pytest.approx(jax_run["best_val_loss"], rel=0.02)
