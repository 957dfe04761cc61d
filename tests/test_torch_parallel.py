"""Port parity: the multi-card layer (ce5g_torch.parallel) on gloo ranks.

Each world size (1, 2 and 4) is one run of ``tests/_torch_ranks.py`` in
that many processes, started once per module: the processes import torch
and ce5g_torch only, run every check of the layer and hand back what they
measured. The JAX package's references (its draws, initial weights,
batches and results) are made here, on the virtual 8-device CPU mesh of
conftest.py, and passed to the ranks as numpy. Tolerances are the JAX
package's own where it has one (rtol 2e-4 for the sharded statistics,
atol 2e-4 for the time-sharded channel); the rest are stated beside each
check.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ce5g_torch.parallel import data_sharding, model_axis_for, replicated
from ce5g_torch.physics.profiles import MAX_PATHS, PROFILE_INDEX

from _torch_parity import jax_draws, port_cfg

REPO = Path(__file__).resolve().parent.parent
FS = 15.36e6
RANK_TIMEOUT_S = 300


def _jax_small_cfg():
    """tests/test_parallel.py's small_cfg, without dropout (the port
    cannot reproduce JAX's dropout masks)."""
    from ce5g_tpu import ExperimentConfig, MIMOConfig, ModelConfig, OFDMConfig, TrainingConfig

    return ExperimentConfig(
        ofdm=OFDMConfig(fft_size=64, cp_length=8, num_symbols=6, useful_subcarriers=40),
        mimo=MIMOConfig(num_tx=2, num_rx=2),
        model=ModelConfig(cnn_hidden_channels=(8, 16), cnn_dropout=0.0),
        training=TrainingConfig(batch_size=8, mixed_precision=False),
    )


def _mesh1():
    from ce5g_tpu.parallel import make_mesh

    return make_mesh(data=1, model=1, devices=jax.devices()[:1])


def _time_cases():
    """tests/test_time_sharded.py's cases: EPA and ETU at n = 4096 (2×2,
    200 Hz, halo 128), and ETU at n = 1024 (1×1, 50 Hz) with halo 40,
    shorter than its 77-sample delay, and 77. Each with the JAX package's
    monolithic result."""
    from ce5g_tpu import ExperimentConfig
    from ce5g_tpu.parallel.time_sharded import reference_time_domain_apply
    from ce5g_tpu.physics import table_for
    from ce5g_tpu.physics.jakes import jakes_oscillator_params

    table = table_for(ExperimentConfig())
    cases = {}
    for name, profile, n, ants, doppler, seeds, halo in (
            ("EPA", "EPA", 4096, 2, 200.0, (0, 1, 2), 128),
            ("ETU", "ETU", 4096, 2, 200.0, (0, 1, 2), 128),
            ("ETU_halo40", "ETU", 1024, 1, 50.0, (3, 4, 5), 40),
            ("ETU_halo77", "ETU", 1024, 1, 50.0, (3, 4, 5), 77)):
        pi = PROFILE_INDEX[profile]
        key = jax.random.key(seeds[0])
        x = jax.lax.complex(jax.random.normal(jax.random.key(seeds[1]), (ants, n), jnp.float32),
                            jax.random.normal(jax.random.key(seeds[2]), (ants, n), jnp.float32))
        amp, delays, valid = (table.amp_overwrite[pi], table.delay_samples[pi],
                              table.path_valid[pi])
        mono = reference_time_domain_apply(x, key, doppler, jnp.asarray(amp),
                                           jnp.asarray(delays), jnp.asarray(valid), FS,
                                           ants, ants)
        angles, phases = jakes_oscillator_params(key, MAX_PATHS, ants, ants, 20)
        cases[name] = dict(x=np.asarray(x), angles=np.asarray(angles),
                           phases=np.asarray(phases), doppler=doppler, amp=amp, delays=delays,
                           valid=valid, fs=FS, nrx=ants, ntx=ants, halo=halo,
                           jax=np.asarray(mono))
    return cases


def _split(path, n, seed, s=6, k=39):
    """A synthetic npz split in the generator's layout (1×1 frames)."""
    rng = np.random.default_rng(seed)

    def cn(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    h = cn(n, s, 1, 1, k)
    np.savez(path, rx_symbols=cn(n, s, 1, k), tx_symbols=cn(n, s, 1, k), H_true=h,
             H_ls=(h + 0.3 * cn(n, s, 1, 1, k)).astype(np.complex64),
             pilot_mask=(rng.random((n, s, k)) < 0.3).astype(np.float32),
             snr_db=np.full(n, 10.0, np.float32), doppler_hz=np.full(n, 50.0, np.float32),
             pilot_density=np.full(n, 0.1, np.float32), profile_idx=np.zeros(n, np.int32))
    return str(path)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """What every world size is given, and the JAX package's results."""
    from flax import nnx

    from ce5g_tpu.data.generator import draw_params
    from ce5g_tpu.models import get_model
    from ce5g_tpu.parallel import run_one_sharded_step, sharded_eval_stats_fn
    from ce5g_tpu.train.checkpoint import _flatten

    jcfg = _jax_small_cfg()
    keys = jax.random.split(jax.random.key(3), 8)
    kp = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
    ks = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)
    jstats = sharded_eval_stats_fn(jcfg, _mesh1())(keys)

    jmodel = get_model("cnn", jcfg.model, dtype=jnp.float32, seed=jcfg.seed)
    state = _flatten(nnx.to_pure_dict(nnx.state(jmodel, nnx.Not(nnx.RngState))))
    bkey = jax.random.key(0)  # train_sharded.py:73-88's synthetic batch
    batch = (np.asarray(jax.random.normal(bkey, (8, 6, 40, 5), jnp.float32)),
             np.asarray(jax.random.normal(bkey, (8, 6, 40, 2), jnp.float32)),
             np.zeros((8, 6, 40), np.float32))
    jloss = run_one_sharded_step(jcfg, _mesh1(), batch_size=8, grid=(6, 40), model_type="cnn")

    splits = tmp_path_factory.mktemp("splits")
    cfg = port_cfg(jcfg)
    inputs = {
        "cfg": cfg,
        "params": [np.asarray(x) for x in draw_params(kp, jcfg)],
        "draws": [x.numpy() for x in jax_draws(ks, jcfg)],
        "td": _time_cases(),
        "train_cfg": dataclasses.replace(
            cfg, training=dataclasses.replace(cfg.training, batch_size=4)),
        "jax_state": state,
        "batch": batch,
        "train_split": _split(splits / "train.npz", 4, 5),
        "val_split": _split(splits / "val.npz", 4, 6),
    }
    jax_results = {"stats": {k: float(v) for k, v in jstats.items()}, "loss": float(jloss)}
    return inputs, jax_results


def _run_ranks(world, inputs, workdir):
    with open(workdir / "inputs.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "_torch_ranks.py"),
                               str(r), str(world), str(workdir)],
                              env=env, cwd=workdir, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, failed
    outs = []
    for r in range(world):
        with open(workdir / f"out_{r}.pkl", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """{world: [each rank's results]} for worlds 1, 2 and 4."""
    inputs, _ = reference
    return {w: _run_ranks(w, inputs, tmp_path_factory.mktemp(f"world{w}")) for w in (1, 2, 4)}


# ------------------------------------------------------------------- mesh
def test_make_mesh_shapes_and_errors(ranks):
    for w in (1, 2, 4):
        for out in ranks[w]:
            assert out["mesh"] == {"data": w, "model": 1}
            assert "3x2" in out["mesh_error"]
    for out in ranks[4]:
        assert out["mesh_2x2"] == {"data": 2, "model": 2}
        # the rule's placements; the mean of ranks (0, 2) or (1, 3) over 'data'
        assert out["placements"] == {"w": ["Replicate", "Shard(1)"],
                                     "b": ["Replicate", "Replicate"],
                                     "odd": ["Replicate", "Replicate"]}
    assert sorted(out["psum_mean"] for out in ranks[4]) == [1.0, 1.0, 2.0, 2.0]
    from torch.distributed.tensor import Replicate, Shard

    assert data_sharding(None) == (Shard(0), Replicate())
    assert replicated(None) == (Replicate(), Replicate())


def _jax_specs(tree):
    from ce5g_tpu.parallel import make_mesh, shard_model_state

    mesh = make_mesh(data=4, model=2)
    out = shard_model_state({k: jnp.asarray(v) for k, v in tree.items()}, mesh)
    return {k: v.sharding.spec for k, v in out.items()}


def _axis_of(spec, ndim):
    axes = [i for i, a in enumerate(tuple(spec) + (None,) * ndim) if a == "model"]
    return axes[0] if axes else None


@pytest.mark.parametrize("what", ["test_parallel_shapes", "cnn", "resnet"])
def test_model_axis_for_matches_jax(what):
    """model_axis_for against the JAX package's shard_model_state specs on a
    2-wide 'model' axis: tests/test_parallel.py:40-50's shapes, and every
    parameter and statistic of the default cnn and resnet."""
    from flax import nnx

    from ce5g_tpu import ModelConfig
    from ce5g_tpu.models import get_model
    from ce5g_tpu.train.checkpoint import _flatten

    if what == "test_parallel_shapes":
        tree = {"w": np.ones((6, 16)), "b": np.ones((7,)), "odd": np.ones((3, 5))}
    else:
        model = get_model(what, ModelConfig(), seed=0)
        tree = _flatten(nnx.to_pure_dict(nnx.state(model, nnx.Not(nnx.RngState))))
    specs = _jax_specs(tree)
    for name, x in tree.items():
        assert model_axis_for(x.shape, 2) == _axis_of(specs[name], x.ndim), name
        assert model_axis_for(x.shape, 1) is None
    if what == "test_parallel_shapes":
        assert [model_axis_for(tree[k].shape, 2) for k in ("w", "b", "odd")] == [1, None, None]


# ------------------------------------------------------ sharded statistics
def test_sharded_eval_stats_match_world_one_and_jax(reference, ranks):
    """Every rank at world 2 and 4 returns world 1's statistics (rtol 2e-4,
    as tests/test_parallel.py:118); world 1 equals the JAX package's on
    its own draws within 0.01 dB of NMSE (rtol 2.3e-3), as the port's
    estimator tests hold mmse_full."""
    _, jax_results = reference
    one = ranks[1][0]["eval"]["stats"]
    for w in (2, 4):
        for out in ranks[w]:
            for k in ("mse", "nmse", "ber"):
                np.testing.assert_allclose(out["eval"]["stats"][k], one[k], rtol=2e-4)
    for k in ("mse", "nmse", "ber"):
        np.testing.assert_allclose(one[k], jax_results["stats"][k], rtol=2.3e-3)
    assert abs(one["nmse_db"] - jax_results["stats"]["nmse_db"]) < 0.01
    assert 0 < one["ber"] <= 0.5


def test_sharded_generate_slices_make_the_chunk(ranks):
    """The ranks' slices, in 'data' order, are world 1's chunk."""
    whole = ranks[1][0]["eval"]["generate"]
    for w in (2, 4):
        for k, v in whole.items():
            got = np.concatenate([out["eval"]["generate"][k] for out in ranks[w]])
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-6 * np.abs(v).max())


# ------------------------------------------------- time-sharded channel
@pytest.mark.parametrize("case", ["EPA", "ETU"])
def test_time_sharded_equals_monolithic(reference, ranks, case):
    """The blocks of world 2 and 4 in rank order equal the port's and the
    JAX package's monolithic channel (atol 2e-4, as
    tests/test_time_sharded.py:72)."""
    from ce5g_torch.parallel import reference_time_domain_apply

    c = reference[0]["td"][case]
    mono = reference_time_domain_apply(
        *(torch.tensor(c[k]) for k in ("x", "angles", "phases")), c["doppler"],
        *(torch.tensor(c[k]) for k in ("amp", "delays", "valid")), FS, c["nrx"], c["ntx"])
    np.testing.assert_allclose(mono.numpy(), c["jax"], atol=2e-4)
    for w in (1, 2, 4):
        got = np.concatenate([out["td"][case] for out in ranks[w]], axis=-1)
        np.testing.assert_allclose(got, mono.numpy(), atol=2e-4)


def test_halo_shorter_than_the_delay_breaks_etu(reference, ranks):
    """Halo 77, ETU's longest delay, is exact; 40 visibly is not."""
    jax_mono = reference[0]["td"]["ETU_halo77"]["jax"]
    for w in (2, 4):
        ok = np.concatenate([out["td"]["ETU_halo77"] for out in ranks[w]], axis=-1)
        bad = np.concatenate([out["td"]["ETU_halo40"] for out in ranks[w]], axis=-1)
        np.testing.assert_allclose(ok, jax_mono, atol=2e-4)
        assert not np.allclose(bad, jax_mono, atol=1e-3)


# ------------------------------------------------------------ training
def test_sharded_train_step_matches_jax_and_world_one(reference, ranks):
    """One step of the cnn on JAX's initial weights and batch: the loss
    within 1e-4 relative of the JAX package's run_one_sharded_step at
    world 1, 2 (data parallel) and 4 (2 data × 2 model); the averaged
    gradients within 1e-5 of each tensor's rms of world 1's, except the
    conv biases in front of BatchNorm, whose gradient is rounding noise
    (held within 1e-5 of the largest gradient rms instead)."""
    _, jax_results = reference
    one = ranks[1][0]["step"]
    assert ranks[4][0]["step"]["mesh"] == {"data": 2, "model": 2}
    floor = max(np.sqrt(np.mean(g ** 2)) for g in one["grads"].values())
    for w in (1, 2, 4):
        for out in ranks[w]:
            np.testing.assert_allclose(out["step"]["loss"], jax_results["loss"], rtol=1e-4)
    for w in (2, 4):
        for name, g in ranks[w][0]["step"]["grads"].items():
            ref = one["grads"][name]
            scale = np.sqrt(np.mean(ref ** 2))
            if name.endswith("conv.bias"):
                scale = floor
            assert np.max(np.abs(g - ref)) <= 1e-5 * scale, name


def test_batchnorm_statistics_are_global(ranks):
    """BatchNorm's running statistics after the step equal world 1's (the
    global batch's) on every rank, within 1e-5 relative."""
    one = ranks[1][0]["step"]["buffers"]
    assert any("running_var" in n for n in one)
    for w in (2, 4):
        for out in ranks[w]:
            for name, b in out["step"]["buffers"].items():
                np.testing.assert_allclose(b, one[name], rtol=1e-5, atol=1e-7)


def test_trainer_on_a_mesh_matches_the_meshless_trainer(ranks):
    """Trainer(mesh=...) at world 2, two steps (two epochs of one batch of
    4): the steps' losses within 1e-5 relative of the meshless Trainer's,
    the validation losses within 1e-4 (test_torch_train.py's
    HISTORY_RTOL: the meshless Trainer's own validation loss moves by
    4e-5 between CPU thread counts); only rank 0 writes checkpoints and
    history."""
    one = ranks[1][0]["trainer"]["history"]
    for out in ranks[2]:
        h = out["trainer"]["history"]
        np.testing.assert_allclose(h["train_loss"], one["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(h["val_loss"], one["val_loss"], rtol=1e-4)
    assert [out["trainer"]["wrote"] for out in ranks[2]] == [True, False]


def test_dryrun_multichip_at_world_four(ranks):
    """dryrun_multichip on small_cfg's widths: finite losses for every
    family and a positive NMSE, the same on every rank."""
    first = ranks[4][0]["dryrun"]
    assert set(first) == {"cnn", "resnet", "transformer", "lstm", "hybrid", "nmse"}
    assert all(np.isfinite(v) for v in first.values()) and first["nmse"] > 0
    for out in ranks[4][1:]:
        assert out["dryrun"] == pytest.approx(first, rel=1e-6)
