"""Port parity: ce5g_torch.models and the checkpoint loader against
ce5g_tpu.models.

Every committed ``*_best`` checkpoint is built by both packages through
``ModelEvaluator.load_model`` and fed the same random NHWC batch on a
small grid (the weights are the trained ones; every family takes any
grid). Eval-mode outputs agree within 1e-4 of the output's rms, and the
trainable-parameter counts agree exactly. Random-init checkpoints of every
``MODEL_TYPES`` entry round-trip both ways between the packages' own
``save_checkpoint`` and ``load_checkpoint``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ce5g_torch.convert import model_state_from_numpy, model_state_to_numpy
from ce5g_torch.eval.evaluate import ModelEvaluator
from ce5g_torch.models import MODEL_TYPES, count_parameters, get_model
from ce5g_torch.models import inputs as tinputs
from ce5g_torch.train import load_checkpoint, save_checkpoint

from _torch_parity import port_cfg

TOL = 1e-4  # max |port − JAX| over the output's rms

#: every committed trained checkpoint, (model dir, model name)
CHECKPOINTS = [
    ("models", "cnn"),
    ("models", "cnn_wiener"),
    ("models", "cnn_wiener_mse"),
    ("models", "hybrid"),
    ("models", "lstm"),
    ("models", "resnet"),
    ("models_simo", "cnn"),
    ("models_simo", "cnn_wiener"),
    ("models_simo", "cnn_wiener_blind"),
    ("models_simo", "cnn_wiener_blind_online"),
    ("models_simo", "hybrid"),
    ("models_simo", "lstm"),
    ("models_simo", "resnet"),
    ("models_simo", "transformer"),
]

#: trainable parameters of the default-width families (results_simo/*.json)
PARAMS = {"cnn": 742210, "hybrid": 2458690, "resnet": 312450, "transformer": 478978}

SMALL_MODELS = dict(
    cnn_hidden_channels=(8, 16),
    lstm_hidden_size=8,
    lstm_num_layers=2,
    hybrid_cnn_channels=(8,),
    hybrid_lstm_hidden=8,
    hybrid_lstm_layers=2,
    resnet_base_channels=8,
    resnet_num_blocks=2,
)


def _batch(model_name, seed=0):
    """A random batch in the model's layout: (2, 96, 4) for the LSTM,
    (2, 4, 24, 5 or 7) NHWC for the grid models."""
    rng = np.random.default_rng(seed)
    if model_name == "lstm":
        return rng.standard_normal((2, 96, 4)).astype(np.float32)
    c = 7 if "_wiener" in model_name else 5
    return rng.standard_normal((2, 4, 24, c)).astype(np.float32)


def _torch_out(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _assert_close(got, ref):
    rms = np.sqrt(np.mean(ref.astype(np.float64) ** 2))
    err = np.max(np.abs(got - ref))
    assert got.shape == ref.shape
    assert err <= TOL * rms, (err, rms)


@pytest.mark.parametrize("model_dir,name", CHECKPOINTS)
def test_committed_checkpoint_matches_jax(cfg, tmp_path, model_dir, name):
    from ce5g_tpu.eval.evaluate import ModelEvaluator as JModelEvaluator
    from ce5g_tpu.models import count_parameters as j_count

    jmodel, jmeta = JModelEvaluator(cfg, model_dir, results_dir=str(tmp_path)).load_model(name)
    tmodel, tmeta = ModelEvaluator(port_cfg(cfg), model_dir, device="cpu").load_model(name)
    assert tmeta == jmeta
    assert not tmodel.training
    x = _batch(name)
    _assert_close(_torch_out(tmodel, x), np.asarray(jmodel(jnp.asarray(x), train=False)))
    n = count_parameters(tmodel)
    assert n == j_count(jmodel)
    arch = name.split("_")[0]
    if arch in PARAMS:
        assert n == PARAMS[arch] + (1152 if "_wiener" in name else 0)  # 2 more input channels


def _small_jax_cfg(cfg):
    from ce5g_tpu.config import ModelConfig

    return dataclasses.replace(cfg, model=ModelConfig(**SMALL_MODELS))


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_jax_checkpoint_loads_into_port(cfg, tmp_path, model_type):
    from ce5g_tpu.models import get_model as j_get_model
    from ce5g_tpu.train import save_checkpoint as j_save

    jcfg = _small_jax_cfg(cfg)
    jmodel = j_get_model(model_type, jcfg.model, seed=3)
    j_save(tmp_path / "ck", jmodel, epoch=7)
    tmodel = get_model(model_type, port_cfg(jcfg).model, seed=1, device="cpu")
    assert load_checkpoint(tmp_path / "ck", tmodel) == {"epoch": 7}
    name = "lstm" if model_type == "lstm" else "cnn"
    x = _batch(name, seed=4)
    _assert_close(_torch_out(tmodel, x), np.asarray(jmodel(jnp.asarray(x), train=False)))


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_port_checkpoint_loads_into_jax(cfg, tmp_path, model_type):
    from ce5g_tpu.models import get_model as j_get_model
    from ce5g_tpu.train import load_checkpoint as j_load

    jcfg = _small_jax_cfg(cfg)
    tmodel = get_model(model_type, port_cfg(jcfg).model, seed=5, device="cpu")
    # BatchNorm statistics of their own, from a generator of the test's own:
    # means near zero and variances near one keep the ReLUs open, so that
    # the output compared is not (nearly) zero
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, buf in tmodel.named_buffers():
            if name.endswith("running_mean"):
                buf.uniform_(-0.1, 0.1, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=gen)
    save_checkpoint(tmp_path / "ck", tmodel, epoch=2, val_loss=0.25)
    jmodel = j_get_model(model_type, jcfg.model, seed=9)
    assert j_load(tmp_path / "ck", jmodel) == {"epoch": 2, "val_loss": 0.25}
    name = "lstm" if model_type == "lstm" else "cnn"
    x = _batch(name, seed=6)
    ref = np.asarray(jmodel(jnp.asarray(x), train=False))
    assert np.sqrt(np.mean(ref.astype(np.float64) ** 2)) > 1e-2  # nothing compared at zero
    _assert_close(ref, _torch_out(tmodel, x))


def test_unidirectional_lstm_round_trip(cfg, tmp_path):
    """``lstm_bidirectional=False``: one ``nnx.RNN`` a layer, named
    ``layers/i/cell/...`` in the checkpoint."""
    from ce5g_tpu.models import get_model as j_get_model
    from ce5g_tpu.train import load_checkpoint as j_load
    from ce5g_tpu.train import save_checkpoint as j_save

    jcfg = _small_jax_cfg(cfg)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                               lstm_bidirectional=False))
    jmodel = j_get_model("lstm", jcfg.model, seed=2)
    j_save(tmp_path / "jax", jmodel)
    tmodel = get_model("lstm", port_cfg(jcfg).model, device="cpu")
    load_checkpoint(tmp_path / "jax", tmodel)
    assert "layers/0/cell/dense_i/kernel" in model_state_to_numpy(tmodel)
    x = _batch("lstm", seed=3)
    _assert_close(_torch_out(tmodel, x), np.asarray(jmodel(jnp.asarray(x), train=False)))
    save_checkpoint(tmp_path / "port", tmodel)
    jback = j_get_model("lstm", jcfg.model, seed=8)
    j_load(tmp_path / "port", jback)
    _assert_close(np.asarray(jback(jnp.asarray(x), train=False)), _torch_out(tmodel, x))


@pytest.mark.parametrize("fault", ["missing", "extra", "misshaped"])
def test_model_state_rejects_a_mismatched_checkpoint(cfg, fault):
    model = get_model("cnn", port_cfg(_small_jax_cfg(cfg)).model, device="cpu")
    flat = model_state_to_numpy(model)
    if fault == "missing":
        del flat["blocks/1/bn/var"]
    elif fault == "extra":
        flat["blocks/9/conv/kernel"] = np.zeros((3, 3, 1, 1), np.float32)
    else:
        flat["out/kernel"] = flat["out/kernel"][..., :1]
    with pytest.raises(ValueError, match="blocks/1/bn/var|blocks/9|out/kernel"):
        model_state_from_numpy(flat, model)


def test_factory_rules(cfg, tmp_path):
    mcfg = port_cfg(_small_jax_cfg(cfg)).model
    hybrid = get_model("cnn_lstm", mcfg, device="cpu")
    assert type(hybrid).__name__ == "HybridCNNLSTMEstimator"
    with pytest.raises(ValueError, match="Unknown model type"):
        get_model("mlp", mcfg, device="cpu")
    # a checkpoint without optimizer state cannot resume training
    save_checkpoint(tmp_path / "ck", hybrid)
    with pytest.raises(FileNotFoundError, match="opt_state.npz"):
        load_checkpoint(tmp_path / "ck", hybrid, torch.optim.SGD(hybrid.parameters(), lr=0.1))
    # the same seed gives the same weights, and the global RNG is untouched
    state = torch.random.get_rng_state()
    a = model_state_to_numpy(get_model("cnn", mcfg, seed=11, device="cpu"))
    b = model_state_to_numpy(get_model("cnn", mcfg, seed=11, device="cpu"))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert torch.equal(torch.random.get_rng_state(), state)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model("cnn", mcfg)  # entry points default to the card


def test_bf16_compute_keeps_float32_params(cfg):
    """``dtype`` is the compute dtype, as in the JAX factory: parameters
    stay float32, the output is float32 and near the float32 model's."""
    mcfg = port_cfg(_small_jax_cfg(cfg)).model
    m32 = get_model("cnn", mcfg, seed=2, device="cpu")
    m16 = get_model("cnn", mcfg, seed=2, dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    x = _batch("cnn", seed=8)
    y32, y16 = _torch_out(m32, x), _torch_out(m16, x)
    assert y16.dtype == np.float32
    assert np.max(np.abs(y16 - y32)) <= 0.05 * np.sqrt(np.mean(y32 ** 2))


def _frame_tensors(seed=0, b=2, s=4, r=2, t=1, k=24):
    rng = np.random.default_rng(seed)

    def cn(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    mask = (rng.random((b, s, k)) < 0.2).astype(np.float32)
    return cn(b, s, r, k), cn(b, s, r, t, k), cn(b, s, r, t, k), mask


@pytest.mark.parametrize("stats", [None, {"rx_std": 2.0, "hls_std": 0.5, "h_std": 1.5}])
def test_grid_and_lstm_inputs_match_jax(stats):
    from ce5g_tpu.models import inputs as jinputs

    arrays = _frame_tensors()
    jb = jinputs.grid_inputs(*(jnp.asarray(a) for a in arrays), stats=stats)
    tb = tinputs.grid_inputs(*(torch.from_numpy(a) for a in arrays), stats=stats)
    for field in ("inputs", "targets", "pilot_mask"):
        np.testing.assert_allclose(getattr(tb, field).numpy(), np.asarray(getattr(jb, field)),
                                   rtol=1e-6, atol=1e-7)
    assert tb.stats == jb.stats
    for got, ref in zip(tinputs.lstm_inputs(tb), jinputs.lstm_inputs(jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("channels", [5, 7])
def test_apply_output_residual_matches_jax(channels):
    from ce5g_tpu.models.inputs import apply_output_residual as j_residual

    rng = np.random.default_rng(channels)
    pred = rng.standard_normal((2, 4, 24, 2)).astype(np.float32)
    x = rng.standard_normal((2, 4, 24, channels)).astype(np.float32)
    got = tinputs.apply_output_residual(torch.from_numpy(pred), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_residual(jnp.asarray(pred),
                                                                     jnp.asarray(x))))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model_dir,name", CHECKPOINTS)
def test_committed_checkpoint_card_matches_cpu(cfg, card, model_dir, name):
    """cuDNN in full float32 against the CPU on the same weights."""
    tcfg = port_cfg(cfg)
    on_card, _ = ModelEvaluator(tcfg, model_dir, device=card).load_model(name)
    on_cpu, _ = ModelEvaluator(tcfg, model_dir, device="cpu").load_model(name)
    x = _batch(name)
    with torch.no_grad():
        got = on_card(torch.from_numpy(x).to(card)).cpu().numpy()
    _assert_close(got, _torch_out(on_cpu, x))
