"""Port parity: the serving slice (split → dataset → baselines, classical
estimators and checkpoint evaluation) against ce5g_tpu on the CPU.

A small 1×2 SIMO split is generated by ce5g_tpu's ``generate_chunk_fn``
and its Wiener feature by ce5g_tpu's ``mmse_full``; both packages then read
the same npz file. Per-sample NMSE agrees within 1e-4 relative for the
stored baselines, LS, diagonal MMSE and the models; within 0.01 dB for
mmse_full, the tolerance of tests/test_torch_estimators.py (the JAX
package's Woodbury cancellation amplifies its float32 rounding). The port's
``generate_chunk`` on the JAX package's own draws gives the JAX chunk.
"""
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

from ce5g_torch.config import config_from_dict, load_config
from ce5g_torch.data import CHUNK_KEYS, draw_params, generate_chunk, read_chunk, read_split
from ce5g_torch.data.generator import _write_chunk, _write_npz
from ce5g_torch.eval import evaluate as tevaluate
from ce5g_torch.physics import FrameParams
from ce5g_torch.train import ChannelDataset
from ce5g_torch.utils import ber_approximation, db2linear, linear2db

from _torch_parity import assert_close_to_power, jax_draws, port_cfg

FRAMES = 6
MODELS = ("cnn", "cnn_wiener", "lstm")
NMSE_RTOL = 1e-4
MMSE_FULL_DB = 0.01


@pytest.fixture(scope="module")
def jcfg():
    """1×2 SIMO at a narrow numerology; SNR ≤ 20 dB as in
    tests/test_torch_estimators.py (the JAX package's mmse_full cancellation)."""
    from ce5g_tpu import (ExperimentConfig, MIMOConfig, ModelConfig, OFDMConfig, PilotConfig,
                          SimulationConfig)

    return ExperimentConfig(
        ofdm=OFDMConfig(fft_size=64, cp_length=8, num_symbols=6, useful_subcarriers=40),
        mimo=MIMOConfig(num_tx=1, num_rx=2),
        pilots=PilotConfig(density=(0.05, 0.10), max_density=0.15),
        simulation=SimulationConfig(snr_range_db=(0.0, 10.0, 20.0)),
        model=ModelConfig(cnn_hidden_channels=(8, 8), lstm_hidden_size=8, lstm_num_layers=2),
    )


@pytest.fixture(scope="module")
def served(jcfg, tmp_path_factory):
    """The JAX chunk of FRAMES frames with H_wiener, as an npz split; the
    port's chunk from the same parameters and draws; and a model
    directory of random-init JAX checkpoints."""
    from ce5g_tpu.data.generator import draw_params as j_draw_params
    from ce5g_tpu.data.generator import generate_chunk_fn
    from ce5g_tpu.estimators.api import estimate_batch as j_estimate_batch
    from ce5g_tpu.eval.evaluate import _frames_from_arrays as j_frames
    from ce5g_tpu.models import get_model as j_get_model
    from ce5g_tpu.train import save_checkpoint as j_save

    root = tmp_path_factory.mktemp("served")
    keys = jax.random.split(jax.random.key(7), FRAMES)
    arrays = {k: np.asarray(v) for k, v in generate_chunk_fn(jcfg)(keys).items()}
    frames = j_frames(arrays, np.arange(FRAMES), jcfg)
    wiener = jax.jit(functools.partial(j_estimate_batch, cfg=jcfg, estimator="mmse_full"))
    arrays["H_wiener"] = np.asarray(wiener(frames))[:, :, 0, 0, :]
    np.savez(root / "test.npz", **arrays)

    kp = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
    ks = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)
    params = FrameParams(*(torch.tensor(np.asarray(x)) for x in j_draw_params(kp, jcfg)))
    port_chunk = generate_chunk(port_cfg(jcfg), params, jax_draws(ks, jcfg), device="cpu")

    for name in MODELS:
        arch = name.split("_wiener")[0]
        mcfg = jcfg.model
        if "_wiener" in name:
            mcfg = dataclasses.replace(mcfg, input_channels=7)
        j_save(root / "models" / f"{name}_best", j_get_model(arch, mcfg, seed=len(name)),
               epoch=1)
    return root, arrays, port_chunk


def test_simo_config_literal_matches_yaml():
    """chip_smoke.py's copy of configs/simo_identifiable.yaml, field by
    field, against the port's and the JAX package's loaders."""
    import chip_smoke
    from ce5g_tpu.config import load_config as j_load_config

    literal = dataclasses.asdict(config_from_dict(chip_smoke.SIMO_CONFIG))
    assert literal == dataclasses.asdict(load_config("configs/simo_identifiable.yaml"))
    assert literal == dataclasses.asdict(j_load_config("configs/simo_identifiable.yaml"))


@pytest.mark.parametrize("key", CHUNK_KEYS)
def test_generate_chunk_matches_jax(served, key):
    _, arrays, port_chunk = served
    got, ref = port_chunk[key].numpy(), arrays[key]
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if np.iscomplexobj(ref):
        assert_close_to_power(got, ref, 1e-4)
    else:
        np.testing.assert_array_equal(got, ref)


def test_draw_params_law(jcfg):
    cfg = port_cfg(jcfg)
    n = 400
    a = draw_params(cfg, n, torch.Generator().manual_seed(3), device="cpu")
    b = draw_params(cfg, n, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    lists = {"profile_idx": [0, 1, 2], "doppler_hz": cfg.channel.doppler_hz,
             "snr_db": cfg.simulation.snr_range_db, "pilot_density": cfg.pilots.density}
    for name, values in lists.items():
        got = getattr(a, name)
        assert got.shape == (n,)
        # every listed value is drawn, and nothing else
        np.testing.assert_allclose(np.unique(got.numpy()), np.sort(np.float32(values)))
    assert a.profile_idx.dtype == torch.int32 and a.snr_db.dtype == torch.float32


@pytest.mark.parametrize("wiener", [False, True])
def test_dataset_batches_match_jax(served, wiener):
    from ce5g_tpu.train import ChannelDataset as JChannelDataset

    root = served[0]
    jds = JChannelDataset(str(root / "test.npz"), wiener=wiener)
    tds = ChannelDataset(root / "test.npz", wiener=wiener)
    assert tds.stats == jds.stats and len(tds) == len(jds) == FRAMES
    assert tds.grid_shape == jds.grid_shape
    idx = np.array([4, 1, 2])
    jb, tb = jds.make_batch(idx), tds.make_batch(idx)
    assert tb.inputs.shape[-1] == (7 if wiener else 5)
    for field in ("inputs", "targets", "pilot_mask"):
        np.testing.assert_array_equal(getattr(tb, field), getattr(jb, field))
    meta = tds.metadata_batch(idx)
    np.testing.assert_array_equal(meta["snr_db"], jds.arrays["snr_db"][idx])
    assert list(meta["channel_type"]) == [("EPA", "EVA", "ETU")[i]
                                          for i in jds.arrays["profile_idx"][idx]]
    got = [b.inputs for b in tds.batches(4, shuffle=True, seed=1, drop_remainder=False)]
    ref = [b.inputs for b in jds.batches(4, shuffle=True, seed=1, drop_remainder=False)]
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def _assert_per_sample(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape == (FRAMES,)
    np.testing.assert_allclose(got, ref, rtol=rtol)


def test_evaluate_baselines_matches_jax(served):
    from ce5g_tpu.eval.evaluate import evaluate_baselines as j_baselines
    from ce5g_tpu.train import ChannelDataset as JChannelDataset

    root = served[0]
    ref = j_baselines(JChannelDataset(str(root / "test.npz")))
    got = tevaluate.evaluate_baselines(ChannelDataset(root / "test.npz"))
    for name in ("LS", "MMSE"):
        _assert_per_sample(got["per_sample"][name], ref["per_sample"][name], NMSE_RTOL)
        assert abs(got[name]["nmse_db_slice"] - ref[name]["nmse_db_slice"]) < 1e-3


@pytest.mark.parametrize("estimator", ["ls", "mmse", "mmse_full"])
def test_evaluate_estimators_matches_jax(served, jcfg, estimator):
    """Batches of 4 over 6 frames: the last batch is realigned to frames
    2-5 and only its new frames count."""
    from ce5g_tpu.eval.evaluate import evaluate_estimators as j_estimators
    from ce5g_tpu.train import ChannelDataset as JChannelDataset

    root = served[0]
    ref = j_estimators(JChannelDataset(str(root / "test.npz")), jcfg, (estimator,),
                       batch_size=4)[estimator]
    got = tevaluate.evaluate_estimators(ChannelDataset(root / "test.npz"), port_cfg(jcfg),
                                        (estimator,), batch_size=4, device="cpu")[estimator]
    assert got["num_samples"] == ref["num_samples"] == FRAMES
    if estimator == "mmse_full":
        db = 10 * np.log10(np.asarray(got["per_sample"]) / np.asarray(ref["per_sample"]))
        assert np.max(np.abs(db)) < MMSE_FULL_DB, db
    else:
        _assert_per_sample(got["per_sample"], ref["per_sample"], NMSE_RTOL)


@pytest.mark.parametrize("model_type", MODELS)
def test_evaluate_model_matches_jax(served, jcfg, model_type):
    from ce5g_tpu.eval.evaluate import ModelEvaluator as JModelEvaluator
    from ce5g_tpu.train import ChannelDataset as JChannelDataset

    root = served[0]
    ref = JModelEvaluator(jcfg, str(root / "models"), str(root / "jax_results")).evaluate_model(
        model_type, JChannelDataset(str(root / "test.npz"), wiener=True), batch_size=4)
    ev = tevaluate.ModelEvaluator(port_cfg(jcfg), root / "models", device="cpu")
    got = ev.evaluate_model(model_type, ChannelDataset(root / "test.npz", wiener=True),
                            batch_size=4)
    _assert_per_sample(got["per_sample_nmse"], ref["per_sample_nmse"], NMSE_RTOL)
    for key in ("model", "checkpoint_epoch", "params", "num_samples", "basis"):
        assert got[key] == ref[key], key


def test_snr_sweep_matches_jax(served, jcfg):
    from ce5g_tpu.eval.evaluate import ModelEvaluator as JModelEvaluator
    from ce5g_tpu.train import ChannelDataset as JChannelDataset

    root = served[0]
    ref = JModelEvaluator(jcfg, str(root / "models"), str(root / "jax_results")).snr_sweep(
        JChannelDataset(str(root / "test.npz")), ["cnn"], estimators=("ls",))
    got = tevaluate.ModelEvaluator(port_cfg(jcfg), root / "models", device="cpu").snr_sweep(
        ChannelDataset(root / "test.npz"), ["cnn"], estimators=("ls",))
    assert got.keys() == ref.keys()
    for method in ref:
        assert got[method].keys() == ref[method].keys()
        for snr, r in ref[method].items():
            assert abs(got[method][snr]["nmse_db"] - r["nmse_db"]) < 1e-3
            np.testing.assert_allclose(got[method][snr]["ber"], r["ber"], rtol=1e-4)


def test_split_files_and_results_dir(served, tmp_path):
    root, arrays, _ = served
    # a manifest of npz chunks reads as the merged split
    _write_npz(tmp_path / "c0.npz", {k: v[:2] for k, v in arrays.items()})
    _write_npz(tmp_path / "c1.npz", {k: v[2:] for k, v in arrays.items()})
    (tmp_path / "test_manifest.json").write_text(json.dumps({"files": ["c0.npz", "c1.npz"]}))
    split = read_split(tmp_path / "test_manifest.json")
    assert split.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(split[k], arrays[k])
    merged = ChannelDataset(tmp_path / "test_manifest.json", wiener=True)
    whole = ChannelDataset(root / "test.npz", wiener=True)
    for k in arrays:
        np.testing.assert_array_equal(merged.arrays[k], whole.arrays[k])
    assert merged.stats == whole.stats
    # .ce5g and .h5 chunks read back as written
    for suffix in (".ce5g", ".h5"):
        _write_chunk(tmp_path / f"test_chunk_00000{suffix}", arrays, suffix[1:])
        back = read_chunk(tmp_path / f"test_chunk_00000{suffix}")
        for k in arrays:
            np.testing.assert_array_equal(back[k], arrays[k])
    # a merged file carries its Wiener feature in the file, or has none
    np.savez(tmp_path / "plain.npz", **{k: v for k, v in arrays.items() if k != "H_wiener"})
    with pytest.raises(ValueError, match="manifest-backed split"):
        ChannelDataset(tmp_path / "plain.npz", wiener=True)
    # the evaluator writes only into the results_dir it was given
    ev = tevaluate.ModelEvaluator(port_cfg(dataclasses.replace(
        load_config(), results_dir=str(tmp_path / "never"))), root / "models", device="cpu")
    with pytest.raises(ValueError, match="no results_dir"):
        ev.save_results({"a": 1})
    assert not (tmp_path / "never").exists()
    ev = tevaluate.ModelEvaluator(load_config(), root / "models", tmp_path / "out", device="cpu")
    assert json.loads(ev.save_results({"a": 1.5}).read_text()) == {"a": 1.5}


def test_metrics_match_jax():
    from ce5g_tpu.utils import metrics as jmetrics

    snr = np.array([-5.0, 0.0, 10.0, 30.0])
    nmse = np.array([0.5, 0.1, 0.01, 1e-4])
    np.testing.assert_allclose(db2linear(snr).numpy(), np.asarray(jmetrics.db2linear(snr)),
                               rtol=1e-6)
    np.testing.assert_allclose(linear2db(nmse).numpy(), np.asarray(jmetrics.linear2db(nmse)),
                               rtol=1e-6)
    np.testing.assert_allclose(ber_approximation(snr, nmse).numpy(),
                               np.asarray(jmetrics.ber_approximation(snr, nmse)), rtol=1e-5)
