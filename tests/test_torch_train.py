"""Port parity: the training slice of ce5g_torch against ce5g_tpu.

Every case runs in float32 with dropout 0 at narrow widths, from the same
weights in both packages (the JAX model's state loaded into the port's):
BatchNorm's running statistics after a train-mode forward, the
initialisers' statistics, the loss, the per-epoch LR schedule and
``advanced_policy``, one optimizer step, a two-epoch ``Trainer.train``
with its checkpoints, exact resume, and ``DeviceDataset``.
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ce5g_torch.convert import model_state_from_numpy, model_state_to_numpy
from ce5g_torch.models import get_model
from ce5g_torch.models.loss import channel_estimation_loss
from ce5g_torch.train import (ChannelDataset, DeviceDataset, Trainer, advanced_policy,
                              load_checkpoint, lr_schedule_per_epoch)

from _torch_parity import port_cfg

#: narrow widths, no dropout (the packages draw different dropout masks)
SMALL = dict(
    cnn_hidden_channels=(8, 16),
    cnn_dropout=0.0,
    lstm_hidden_size=8,
    lstm_num_layers=2,
    lstm_dropout=0.0,
    hybrid_cnn_channels=(8,),
    hybrid_lstm_hidden=8,
    hybrid_lstm_layers=2,
    resnet_base_channels=8,
    resnet_num_blocks=2,
)
FAMILIES = ("cnn", "lstm", "hybrid", "resnet", "transformer")
STEP_TOL = 1e-5  # one step: max |port − JAX| over the rms of each tensor
#: parameters whose gradient is zero in exact arithmetic: a conv bias in
#: front of BatchNorm (the normalisation removes it) and the attention key
#: bias (softmax removes it). Their gradient is rounding noise, which Adam
#: scales up to a step of ±LR with the noise's sign, in either package.
NO_GRADIENT = re.compile(r"(conv\d?|stem)/bias$|attn/key/bias$")
HISTORY_RTOL = 1e-4  # two epochs: losses, relative


def _jax_state(module):
    from flax import nnx

    from ce5g_tpu.train.checkpoint import _flatten

    return _flatten(nnx.to_pure_dict(nnx.state(module, nnx.Not(nnx.RngState))))


def _small_cfg(cfg, **training):
    from ce5g_tpu.config import ModelConfig

    tr = dict(mixed_precision=False, batch_size=4)
    tr.update(training)
    return dataclasses.replace(cfg, model=ModelConfig(**SMALL),
                               training=dataclasses.replace(cfg.training, **tr))


def _models(jcfg, family, seed=0):
    """The JAX model of ``family`` and the port's with the same weights.
    The transformer is built without dropout (its factory keeps 0.1)."""
    from flax import nnx

    from ce5g_tpu.models import get_model as j_get_model
    from ce5g_tpu.models.transformer import TransformerChannelEstimator as JTransformer
    from ce5g_torch.models import TransformerChannelEstimator

    if family == "transformer":
        jmodel = JTransformer(5, d_model=16, num_heads=2, num_layers=1, dropout=0.0,
                              rngs=nnx.Rngs(seed))
        tmodel = TransformerChannelEstimator(5, d_model=16, num_heads=2, num_layers=1,
                                             dropout=0.0)
    else:
        jmodel = j_get_model(family, jcfg.model, seed=seed)
        tmodel = get_model(family, port_cfg(jcfg).model, device="cpu")
    model_state_from_numpy(_jax_state(jmodel), tmodel)
    return jmodel, tmodel


def _grid_batch(family, n=4, s=4, k=24, seed=0):
    """NHWC (inputs, targets, mask) with a 0/1 pilot mask in channel 4."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, s, k, 5)).astype(np.float32)
    x[..., 4] = (rng.random((n, s, k)) < 0.3).astype(np.float32)
    y = (0.5 * x[..., 2:4] + 0.1 * rng.standard_normal((n, s, k, 2))).astype(np.float32)
    return x, y, x[..., 4]


def _assert_close_rms(got, ref, tol, what="", floor=0.0):
    """max |got − ref| ≤ tol · max(rms(ref), floor)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.sqrt(np.mean(ref ** 2)), floor) or 1.0
    assert np.max(np.abs(got - ref)) <= tol * scale, (what, np.max(np.abs(got - ref)), scale)


# ------------------------------------------------------------ step 0 faults
@pytest.mark.parametrize("what", ["conv_block", "residual_block", "cnn"])
def test_batchnorm_running_statistics_match_jax(cfg, what):
    """One train-mode forward from the same weights moves the running
    statistics as flax does: momentum 0.99 (torch's 0.01) over the biased
    batch variance."""
    from flax import nnx

    from ce5g_tpu.models.cnn import ConvBlock as JConvBlock
    from ce5g_tpu.models.resnet import ResidualBlock as JResidualBlock
    from ce5g_torch.models import ConvBlock, ResidualBlock

    rng = np.random.default_rng(1)
    if what == "cnn":
        jmodel, tmodel = _models(_small_cfg(cfg), "cnn", seed=2)
        x = rng.standard_normal((2, 4, 6, 5)).astype(np.float32) * 2.0 + 0.5
        tin = torch.from_numpy(x)
    else:
        c = 4
        if what == "conv_block":
            jmodel = JConvBlock(3, c, 3, 0.0, dtype=jnp.float32, rngs=nnx.Rngs(2))
            tmodel = ConvBlock(3, c, 3, 0.0)
            x = rng.standard_normal((2, 4, 6, 3)).astype(np.float32) * 2.0 + 0.5
        else:
            jmodel = JResidualBlock(c, 0.0, dtype=jnp.float32, rngs=nnx.Rngs(2))
            tmodel = ResidualBlock(c, 0.0)
            x = rng.standard_normal((2, 4, 6, c)).astype(np.float32) * 2.0 + 0.5
        model_state_from_numpy(_jax_state(jmodel), tmodel)
        tin = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    jmodel(jnp.asarray(x), train=True)
    tmodel.train()
    with torch.no_grad():
        tmodel(tin)
    js, ts = _jax_state(jmodel), model_state_to_numpy(tmodel)
    stats = [k for k in js if k.endswith(("/mean", "/var"))]
    assert stats
    for k in stats:
        assert not np.allclose(js[k], 0.0 if k.endswith("mean") else 1.0)  # they moved
        np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_initialisers_match_jax(cfg, family):
    """get_model draws every parameter from the JAX model's family: zeros
    exactly where flax has zeros, and over three seeds the same mean and,
    for tensors of ≥ 1000 elements, a std within 5%."""
    from ce5g_tpu.models import get_model as j_get_model

    jax_s, port_s = [], []
    for seed in (0, 1, 2):
        jax_s.append(_jax_state(j_get_model(family, cfg.model, seed=seed)))
        port_s.append(model_state_to_numpy(get_model(family, port_cfg(cfg).model, seed=seed,
                                                     device="cpu")))
    assert jax_s[0].keys() == port_s[0].keys()
    for k in jax_s[0]:
        a = np.concatenate([s[k].ravel() for s in jax_s])
        b = np.concatenate([s[k].ravel() for s in port_s])
        if not a.any() or np.all(a == 1.0):  # zero biases, unit scales and variances
            np.testing.assert_array_equal(b, a, err_msg=k)
            continue
        std = a.std()
        assert abs(b.mean() - a.mean()) <= 6.0 * std / np.sqrt(a.size), (k, a.mean(), b.mean())
        if jax_s[0][k].size >= 1000:
            assert abs(b.std() / std - 1.0) <= 0.05, (k, std, b.std())
    if family == "transformer":  # normal(0.02) position tables
        assert abs(port_s[0]["pos_k"].std() - 0.02) < 1e-3


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("pilot_weight", [0.0, 0.5])
@pytest.mark.parametrize("loss_type", ["mse", "mae", "huber", "nmse"])
def test_loss_matches_jax(loss_type, pilot_weight):
    from ce5g_tpu.models.loss import channel_estimation_loss as j_loss

    rng = np.random.default_rng(3)
    pred = (2.0 * rng.standard_normal((3, 4, 6, 2))).astype(np.float32)
    target = rng.standard_normal((3, 4, 6, 2)).astype(np.float32)
    mask = (rng.random((3, 4, 6)) < 0.4).astype(np.float32)
    ref = j_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask), loss_type, 0.7,
                 pilot_weight)
    got = channel_estimation_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                  torch.from_numpy(mask), loss_type, 0.7, pilot_weight)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# -------------------------------------------------------- schedule, policy
@pytest.mark.parametrize("scheduler", ["cosine", "step", "warm_restarts", "plateau"])
def test_lr_schedule_matches_jax(cfg, scheduler):
    from ce5g_tpu.train.trainer import lr_schedule_per_epoch as j_lr

    jcfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, lr_scheduler=scheduler, epochs=40))
    tcfg = port_cfg(jcfg)
    for epoch in range(46):
        assert lr_schedule_per_epoch(tcfg, epoch, 0.5) == j_lr(jcfg, epoch, 0.5)


@pytest.mark.parametrize("family", FAMILIES + ("cnn_lstm",))
def test_advanced_policy_matches_jax(cfg, family):
    from ce5g_tpu.train.trainer import advanced_policy as j_policy

    assert advanced_policy(port_cfg(cfg), family) == port_cfg(j_policy(cfg, family))


# ------------------------------------------------------------ one step
STEP_CASES = [(f, "adam", "active") for f in FAMILIES] + [
    ("cnn", "adam", "inactive"),
    ("cnn", "adamw", "active"),
    ("cnn", "sgd", "active"),
    ("cnn", "sgd", "inactive"),
]


@pytest.mark.parametrize("family,optimizer,clip", STEP_CASES)
def test_one_step_matches_jax(cfg, family, optimizer, clip):
    """One optimizer step from the same weights and batch: the loss and
    every updated parameter and statistic within 1e-5 of its rms. The
    clip is far below the gradient's global norm ('active') or far above
    it ('inactive'). The NO_GRADIENT parameters are held to a step of at
    most the LR instead, and the updated models' outputs (which they do
    not change: in train mode, where BatchNorm uses the batch's
    statistics) to 1e-5 of the rms."""
    from ce5g_tpu.models.inputs import MLBatch
    from ce5g_tpu.train.trainer import Trainer as JTrainer
    from ce5g_torch.models import lstm_inputs

    max_norm = 0.05 if clip == "active" else 1e6
    jcfg = _small_cfg(cfg, optimizer=optimizer, weight_decay=1e-2, gradient_clip=max_norm)
    jmodel, tmodel = _models(jcfg, family)
    jtr = JTrainer(jcfg, model=jmodel, model_type=family, log=lambda *a: None)
    ttr = Trainer(port_cfg(jcfg), model=tmodel, model_type=family, log=lambda *a: None,
                  device="cpu")
    x, y, m = _grid_batch(family)
    if family == "lstm":
        jx, jy = (np.asarray(a) for a in lstm_inputs(MLBatch(torch.from_numpy(x),
                                                             torch.from_numpy(y), None)))
    else:
        jx, jy = x, y
    lr = lr_schedule_per_epoch(ttr.cfg, 0)
    j_loss = jtr._step(jmodel, jtr.optimizer, jnp.asarray(jx), jnp.asarray(jy), jnp.asarray(m),
                       jnp.float32(lr))
    ttr._set_lr(0)
    tmodel.train()
    t_loss = ttr._step(*ttr._layout(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=STEP_TOL)
    norm = float(torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in ttr.params])))
    assert norm == pytest.approx(max_norm, rel=1e-5) if clip == "active" else norm < max_norm
    js, ts = _jax_state(jmodel), model_state_to_numpy(tmodel)
    before = model_state_to_numpy(_models(jcfg, family)[1])
    for k in js:
        if NO_GRADIENT.search(k):
            assert np.max(np.abs(ts[k] - before[k])) <= lr * (1 + STEP_TOL), k
        else:
            _assert_close_rms(ts[k], js[k], STEP_TOL, k)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(jx)).numpy()
    _assert_close_rms(out, np.asarray(jmodel(jnp.asarray(jx), train=True)), STEP_TOL)


# ------------------------------------------------------------ the trainer
def _split(path, n, seed, s=4, k=24):
    """A synthetic npz split in the generator's layout, target ≈ LS."""
    rng = np.random.default_rng(seed)

    def cn(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    h = cn(n, s, 1, 1, k)
    arrays = {
        "rx_symbols": cn(n, s, 1, k),
        "tx_symbols": cn(n, s, 1, k),
        "H_true": h,
        "H_ls": (h + 0.3 * cn(n, s, 1, 1, k)).astype(np.complex64),
        "pilot_mask": (rng.random((n, s, k)) < 0.3).astype(np.float32),
        "snr_db": np.full(n, 10.0, np.float32),
        "doppler_hz": np.full(n, 50.0, np.float32),
        "pilot_density": np.full(n, 0.1, np.float32),
        "profile_idx": np.zeros(n, np.int32),
    }
    np.savez(path, **arrays)
    return path


@pytest.fixture
def splits(tmp_path):
    return _split(tmp_path / "train.npz", 24, 5), _split(tmp_path / "val.npz", 8, 6)


def _port_trainer(jcfg, model=None, **kw):
    return Trainer(port_cfg(jcfg), model=model, model_type="cnn", log=lambda *a: None,
                   device="cpu", **kw)


@pytest.mark.parametrize("device_data", [None, False])
def test_trainer_two_epochs_match_jax(cfg, tmp_path, splits, device_data):
    """Two epochs in both packages from the same init on the same split
    (the JAX package on its device-resident scan; the port device-resident
    or host-staged): histories within 1e-4 relative, the same checkpoint
    set, and the JAX package's load_checkpoint reads the port's _best.
    The optimizer is SGD: under Adam the NO_GRADIENT conv biases take
    ±LR steps of a rounding noise's sign, which the eval-mode BatchNorm's
    lagging running mean then passes into the validation loss (≈2e-4
    relative after two epochs, measured), in either package."""
    from ce5g_tpu.models import get_model as j_get_model
    from ce5g_tpu.train import ChannelDataset as JChannelDataset
    from ce5g_tpu.train import load_checkpoint as j_load
    from ce5g_tpu.train.trainer import Trainer as JTrainer

    jcfg = _small_cfg(cfg, epochs=2, save_freq=1, optimizer="sgd", learning_rate=1e-2)
    jmodel, tmodel = _models(jcfg, "cnn", seed=4)
    train, val = splits
    jtr = JTrainer(jcfg, model=jmodel, model_type="cnn", log=lambda *a: None)
    jres = jtr.train(JChannelDataset(str(train)), JChannelDataset(str(val)),
                     model_dir=str(tmp_path / "jax"))
    ttr = _port_trainer(jcfg, tmodel, device_data=device_data)
    tres = ttr.train(ChannelDataset(train), ChannelDataset(val), model_dir=tmp_path / "port")
    for key in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(tres["history"][key], jres["history"][key],
                                   rtol=HISTORY_RTOL, err_msg=key)
    assert tres["epochs_run"] == jres["epochs_run"] == 2
    names = {p.name for p in (tmp_path / "jax").iterdir()}
    assert names == {p.name for p in (tmp_path / "port").iterdir()}
    back = j_get_model("cnn", jcfg.model, seed=9)
    j_load(tmp_path / "port" / "cnn_best", back)
    x = _grid_batch("cnn", seed=7)[0]
    tmodel.eval()
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x)).numpy()
    _assert_close_rms(out, np.asarray(back(jnp.asarray(x), train=False)), 1e-5)


def test_resume_reproduces_the_unbroken_history(cfg, tmp_path, splits):
    """Train 3 epochs; then 1 epoch, resume from _last, train to 3: the
    histories (but the wall times) are equal exactly."""
    jcfg = _small_cfg(cfg, epochs=3, lr_scheduler="cosine")
    train, val = splits
    whole = _port_trainer(jcfg).train(ChannelDataset(train), ChannelDataset(val),
                                      model_dir=tmp_path / "whole")["history"]
    _port_trainer(jcfg).train(ChannelDataset(train), ChannelDataset(val), epochs=1,
                              model_dir=tmp_path / "cut")
    again = _port_trainer(jcfg)
    assert again.resume(tmp_path / "cut" / "cnn_last") == 1
    hist = again.train(ChannelDataset(train), ChannelDataset(val),
                       model_dir=tmp_path / "cut")["history"]
    for key in ("train_loss", "val_loss", "lr"):
        assert hist[key] == whole[key], key
    with pytest.raises(FileNotFoundError, match="opt_state.npz"):
        load_checkpoint(tmp_path / "cut" / "cnn_best", again.model, again.optimizer)


@pytest.mark.parametrize("wiener", [False, "bwiener"])
def test_device_dataset_equals_make_batch(tmp_path, wiener):
    path = tmp_path / "s.npz"
    _split(path, 10, 8)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["H_wiener"] = arrays["H_true"][:, :, 0, 0, :] * 0.9  # wins for any tag
    np.savez(path, **arrays)
    ds = ChannelDataset(path, wiener=wiener)
    dd = DeviceDataset(ds, build_chunk=3, device="cpu")
    ref = ds.make_batch(np.arange(len(ds)))
    assert len(dd) == 10 and dd.grid_shape == (4, 24) and dd.stats == ds.stats
    np.testing.assert_array_equal(dd.inputs.numpy(), ref.inputs)
    np.testing.assert_array_equal(dd.targets.numpy(), ref.targets)
    np.testing.assert_array_equal(dd.inputs[..., 4].numpy(), ref.pilot_mask)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mixed_precision", [False, True])
def test_trainer_step_on_card_matches_cpu(cfg, tmp_path, splits, card, mixed_precision):
    """One epoch on the card against the CPU from the same weights: float32
    within 1e-4 relative, bf16 autocast within 5% of the float32 loss."""
    jcfg = _small_cfg(cfg, epochs=1, mixed_precision=mixed_precision)
    train, val = splits
    state = model_state_to_numpy(get_model("cnn", port_cfg(jcfg).model, device="cpu"))
    hist = {}
    for where in ("cpu", card):
        model = get_model("cnn", port_cfg(jcfg).model,
                          dtype=torch.bfloat16 if mixed_precision and where != "cpu"
                          else torch.float32, device=where)
        model_state_from_numpy(state, model)
        tr = Trainer(port_cfg(jcfg), model=model, model_type="cnn", log=lambda *a: None,
                     device=where)
        hist[str(where)] = tr.train(ChannelDataset(train), ChannelDataset(val),
                                    model_dir=tmp_path / str(where))["history"]
    tol = 5e-2 if mixed_precision else 1e-4
    np.testing.assert_allclose(hist["cuda"]["train_loss"], hist["cpu"]["train_loss"], rtol=tol)
    np.testing.assert_allclose(hist["cuda"]["val_loss"], hist["cpu"]["val_loss"], rtol=tol)
