"""Port parity: ce5g_torch.data.atscale (the digest manifest and the fused
generate → train path) and the chunk generators of ce5g_torch.utils.rng,
against ce5g_tpu on the CPU."""
import dataclasses
import json
import zlib

import numpy as np
import pytest
import torch

from ce5g_torch.data import DatasetGenerator, atscale, read_chunk
from ce5g_torch.models.inputs import grid_inputs
from ce5g_torch.utils.rng import SPLIT_TAGS, chunk_seed, split_tag

from _torch_parity import one_torch_thread, port_cfg  # noqa: F401 (a fixture)

# bitwise comparisons of two CPU runs: one thread, a fixed reduction order
pytestmark = pytest.mark.usefixtures("one_torch_thread")

UNIT = {"rx_std": 1.0, "hls_std": 1.0, "h_std": 1.0}


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def tcfg(small_cfg):
    return port_cfg(small_cfg)


def test_split_tags_are_fixed_or_a_crc():
    assert [split_tag(s) for s in ("train", "val", "test")] == [0, 1, 2] == list(SPLIT_TAGS.values())
    assert split_tag("online") == zlib.crc32(b"online")
    assert chunk_seed(42, "online", 3, 512) == chunk_seed(42, "online", 3, 512)
    seeds = {chunk_seed(42, s, i, c) for s in ("train", "val", "atscale")
             for i in (0, 1) for c in (8, 16)}
    assert len(seeds) == 12


@pytest.mark.parametrize("kind", ["complex64", "float32", "int32"])
def test_array_digest_matches_jax(kind):
    """The same numpy array digests alike in both packages, within float32
    rounding of the sums (odd length: the alternating sum has a tail)."""
    import jax.numpy as jnp

    from ce5g_tpu.data.atscale import _array_digest as j_digest

    rng = np.random.default_rng(3)
    shape = (5, 7, 3, 13)
    if kind == "complex64":
        v = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    elif kind == "float32":
        v = rng.standard_normal(shape).astype(np.float32)
    else:
        v = rng.integers(0, 3, shape).astype(np.int32)
    got = atscale._array_digest(torch.from_numpy(v)).numpy()
    want = np.asarray(j_digest(jnp.asarray(v)), np.float32)
    assert got.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6 * want[0])


def test_digest_manifest_repeats_and_verifies(tcfg, small_cfg, tmp_path):
    m1 = atscale.generate_digest_split(tcfg, tmp_path, num_samples=16, chunk_size=8,
                                       log=_quiet, device="cpu")
    disk = json.loads((tmp_path / "atscale_digest_manifest.json").read_text())
    assert disk["digests"].keys() == m1["digests"].keys() and m1["num_chunks"] == 2
    assert (m1["backend"], m1["device_name"]) == ("cpu", "cpu")
    for i in range(2):
        assert atscale.verify_digest_chunk(tcfg, m1, i, device="cpu")
    bad = json.loads(json.dumps(m1))
    bad["digests"]["H_true"][1][0] += 1.0
    assert not atscale.verify_digest_chunk(tcfg, bad, 1, device="cpu")
    m2 = atscale.generate_digest_split(tcfg, tmp_path, num_samples=16, chunk_size=8,
                                       log=_quiet, device="cpu")
    assert m2["digests"] == m1["digests"]
    # the JAX package's manifest has no key the port's lacks
    from ce5g_tpu.data import atscale as j_atscale

    ref = j_atscale.generate_digest_split(small_cfg, str(tmp_path / "jax"), num_samples=8,
                                          chunk_size=8, log=_quiet)
    assert set(ref) <= set(m1) and ref["digest_keys"] == m1["digest_keys"]
    assert json.loads(m1["fingerprint"])["chunk_size"] == 8


def test_materialized_chunk_matches_its_digest(tcfg, tmp_path):
    """Chunk 1 written by DatasetGenerator at the digest's chunk size digests
    as the manifest says (the JAX package's tolerance,
    tests/test_atscale.py:62-64)."""
    m = atscale.generate_digest_split(tcfg, tmp_path, num_samples=16, chunk_size=8,
                                      log=_quiet, device="cpu")
    cfg = dataclasses.replace(tcfg, dataset=dataclasses.replace(tcfg.dataset, chunk_size=8,
                                                                save_format="ce5g"))
    gen = DatasetGenerator(cfg, tmp_path / "split", device="cpu")
    gen.generate_split("atscale", 16, log=_quiet)
    arrays = read_chunk(tmp_path / "split" / "atscale_chunk_00001.ce5g")
    for k in m["digests"]:
        if k == "profile_idx":  # materialized chunks store channel_type names
            v = np.asarray([{"EPA": 0, "EVA": 1, "ETU": 2}[c] for c in arrays["channel_type"]],
                           np.int32)
        else:
            v = arrays[k]
        got = atscale._array_digest(torch.from_numpy(v)).numpy()
        want = np.asarray(m["digests"][k][1], np.float32)
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=1e-4 * max(want[0], 1.0))


def test_digest_rejects_partial_chunks(tcfg, tmp_path):
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        atscale.generate_digest_split(tcfg, tmp_path, num_samples=10, chunk_size=8,
                                      device="cpu")


@pytest.fixture(scope="module")
def jax_online(small_cfg, tmp_path_factory):
    from ce5g_tpu.data import atscale as j_atscale

    ckpt = tmp_path_factory.mktemp("jax_online") / "cnn_online"
    return j_atscale.online_train(small_cfg, "cnn", total_samples=32, batch_size=16,
                                  steps_per_dispatch=1, lr_schedule="cosine",
                                  checkpoint_dir=str(ckpt), log=_quiet)


def test_online_train_reports_like_jax(tcfg, small_cfg, jax_online, tmp_path):
    """Two steps: the JAX package's keys, finite losses, and a checkpoint
    that both packages' loaders read."""
    from ce5g_torch.models import get_model
    from ce5g_torch.train import load_checkpoint
    from ce5g_tpu.models.factory import get_model as j_get_model
    from ce5g_tpu.train.checkpoint import load_checkpoint as j_load

    out = atscale.online_train(tcfg, "cnn", total_samples=32, batch_size=16,
                               steps_per_dispatch=1, lr_schedule="cosine",
                               checkpoint_dir=tmp_path / "cnn_online", log=_quiet, device="cpu")
    assert set(jax_online) <= set(out)
    assert (out["steps"], out["total_samples"], out["dtype"]) == (2, 32, "float32")
    assert (jax_online["steps"], jax_online["dtype"]) == (2, "float32")
    assert np.isfinite([out["first_loss"], out["last_loss"]]).all()
    assert out["end_to_end_samples_per_second"] > 0
    meta = load_checkpoint(tmp_path / "cnn_online", get_model("cnn", tcfg.model, device="cpu"))
    assert meta["online"] is True and meta["epoch"] == 2 and meta["last_loss"] == out["last_loss"]
    j_meta = j_load(str(tmp_path / "cnn_online"), j_get_model("cnn", small_cfg.model))
    assert j_meta == meta


@pytest.mark.parametrize("w", [0, 3])
def test_online_batch_is_chunk_w_of_the_split(tcfg, tmp_path, w):
    cfg = dataclasses.replace(tcfg, dataset=dataclasses.replace(tcfg.dataset, chunk_size=8))
    chunk = DatasetGenerator(cfg, tmp_path, device="cpu").chunk_tensors("online", w)
    ref = grid_inputs(chunk["rx_symbols"], chunk["H_ls"], chunk["H_true"], chunk["pilot_mask"],
                      UNIT)
    x, y, m = atscale.online_batch(tcfg, "online", w, 8, UNIT, device="cpu")
    for a, b in zip((x, y, m), ref[:3]):
        assert torch.equal(a, b)


def test_each_online_step_is_a_trainer_step(tcfg, tmp_path):
    """Two online steps leave the model where two Trainer steps on batches
    0 and 1 of the stream leave a model built from the same seed."""
    from ce5g_torch.convert import model_state_to_numpy
    from ce5g_torch.models import get_model
    from ce5g_torch.train import Trainer, load_checkpoint

    with torch.random.fork_rng():  # the same dropout draws in both runs
        torch.manual_seed(5)
        atscale.online_train(tcfg, "cnn", total_samples=16, batch_size=8, steps_per_dispatch=1,
                             checkpoint_dir=tmp_path / "online", log=_quiet, device="cpu")
    online = get_model("cnn", tcfg.model, device="cpu")
    load_checkpoint(tmp_path / "online", online)
    trainer = Trainer(tcfg, model=get_model("cnn", tcfg.model, seed=tcfg.seed, device="cpu"),
                      model_type="cnn", device="cpu", log=_quiet)
    trainer.model.train()
    batches = [atscale.online_batch(tcfg, "online", w, 8, UNIT, device="cpu") for w in range(2)]
    with torch.random.fork_rng():
        torch.manual_seed(5)
        for batch in batches:
            trainer._step(*batch)
    got, ref = model_state_to_numpy(online), model_state_to_numpy(trainer.model)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_online_blind_wiener_layout(tcfg):
    """The 7-channel residual-on-blind-Wiener layout (at ≥ 5% pilots: on the
    6 × 39 grid 1% leaves two pilots a frame)."""
    cfg = dataclasses.replace(tcfg, pilots=dataclasses.replace(tcfg.pilots, density=(0.05, 0.1)))
    x, _, _ = atscale.online_batch(cfg, "online", 0, 8, UNIT, "mmse_full_est", device="cpu")
    assert x.shape == (8, 6, 39, 7) and torch.isfinite(x).all()
    out = atscale.online_train(cfg, "cnn", total_samples=16, batch_size=8, steps_per_dispatch=1,
                               wiener_estimator="mmse_full_est", loss_type="nmse", log=_quiet,
                               device="cpu")
    assert (out["wiener_estimator"], out["loss_type"]) == ("mmse_full_est", "nmse")
    assert np.isfinite(out["last_loss"])


def test_online_bf16(tcfg):
    out = atscale.online_train(tcfg, "cnn", total_samples=16, batch_size=8, steps_per_dispatch=1,
                               dtype=torch.bfloat16, log=_quiet, device="cpu")
    assert out["dtype"] == "bfloat16" and np.isfinite(out["last_loss"])


def test_online_lstm_raises(tcfg):
    with pytest.raises(ValueError, match="lstm"):
        atscale.online_train(tcfg, "lstm", total_samples=16, batch_size=8, device="cpu")
