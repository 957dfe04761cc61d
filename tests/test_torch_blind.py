"""Port parity: ce5g_torch.estimators.blind and estimator='mmse_full_est'
against ce5g_tpu, on the 1×2 SIMO config at its full 14 × 599 grid, on
frames simulated by both packages from the same JAX draws.

The template match is an argmin over 3 profiles × 48 Dopplers whose
scores lie close together (adjacent Dopplers are nearly equal fits): the
profile and Doppler are compared exactly only on frames where the JAX
package's best score beats the runner-up by a relative margin of 1e-3,
and the estimate on frames whose priors both packages found alike. It is
compared elementwise where its float32 rounding allows:
the 75 × 75 Woodbury system has a condition number of 1e3–1e5, rising
with SNR, and at 15–20 dB the rounding of its solve alone puts either
package 1e-3–2e-2 of the rms from a float64 run (measured). At 10 dB one
frame in eight reached 1.3e-3 of the rms and 0.0101 dB of NMSE apart
(measured), so the 1e-3 and 0.01 dB bounds are held at SNR ≤ 5 dB, on
frames drawn at −5, 0 and 5 dB.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ce5g_torch.estimators import estimate_batch
from ce5g_torch.estimators.blind import (blind_tables_for, build_blind_tables,
                                         device_tables_for, estimate_priors)
from ce5g_torch.physics.simulate import table_for

from _torch_parity import jax_params, port_cfg, simulate_both

FRAMES = 8
SEEDS = (0, 1, 2)
TIE_MARGIN = 1e-3  # (runner-up − best) / best of the JAX scores
PRIOR_RTOL = 1e-3
EST_TOL = 1e-3  # max |port − JAX| over the channel rms, SNR ≤ MAX_SNR_DB
MAX_SNR_DB = 5.0
NMSE_TOL_DB = 0.01


@pytest.fixture(scope="module")
def jcfg():
    from ce5g_tpu.config import load_config

    return load_config("configs/simo_identifiable.yaml")


class _ArgminSpy:
    """``jax.numpy`` for ce5g_tpu.estimators.blind, recording the scores
    that each eager (unjitted) ``argmin`` is given."""

    def __init__(self):
        self.scores = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmin(self, x, *args, **kwargs):
        if not isinstance(x, jax.core.Tracer):
            self.scores.append(np.asarray(x))
        return jnp.argmin(x, *args, **kwargs)


def _jax_priors(jcfg, jf):
    """The JAX package's priors of each frame of ``jf``, one frame at a
    time, and each frame's score margin (runner-up − best) / best."""
    import ce5g_tpu.estimators.blind as jblind
    from ce5g_tpu.physics.simulate import table_for as j_table_for

    tables = jblind.blind_tables_for(jcfg, j_table_for(jcfg))
    spy = _ArgminSpy()
    real_jnp = jblind.jnp
    jblind.jnp = spy
    try:
        pri = [jblind.estimate_priors(jf.rx_symbols[i], jf.tx_symbols[i, :, 0, :],
                                      jf.pilot_mask[i], tables, jcfg.mimo.num_tx)
               for i in range(jf.rx_symbols.shape[0])]
    finally:
        jblind.jnp = real_jnp
    jpri = {f: np.stack([np.asarray(getattr(p, f)) for p in pri]) for f in pri[0]._fields}
    best2 = np.array([np.sort(s)[:2] for s in spy.scores])
    return jpri, (best2[:, 1] - best2[:, 0]) / np.maximum(np.abs(best2[:, 0]), 1e-30)


@pytest.fixture(scope="module", params=SEEDS)
def blind_case(request, jcfg):
    """FRAMES frames of one seed in both packages, with the JAX priors
    (one frame at a time, with each frame's score margin) and the JAX
    package's mmse_full_est estimate."""
    from ce5g_tpu.estimators.api import estimate_batch as j_estimate_batch

    seed = request.param
    rng = np.random.default_rng(seed)
    ch, sim, pil = jcfg.channel, jcfg.simulation, jcfg.pilots
    params = jax_params(rng.integers(0, 3, FRAMES), rng.choice(ch.doppler_hz, FRAMES),
                        rng.choice([x for x in sim.snr_range_db if x <= MAX_SNR_DB], FRAMES),
                        rng.choice(pil.density, FRAMES))
    jf, tf = simulate_both(jcfg, params, seed=100 + seed)
    jpri, margins = _jax_priors(jcfg, jf)
    return jf, tf, jpri, margins, np.asarray(_jax_estimator(jcfg, "mmse_full_est")(jf))


@functools.lru_cache(maxsize=None)
def _jax_estimator(jcfg, estimator):
    """The JAX package's estimate_batch, jitted once per estimator."""
    from ce5g_tpu.estimators.api import estimate_batch as j_estimate_batch

    return jax.jit(functools.partial(j_estimate_batch, cfg=jcfg, estimator=estimator))


@pytest.mark.parametrize("config", ["simo", "bench"])
def test_build_blind_tables_match_jax(jcfg, config):
    from ce5g_tpu.config import ExperimentConfig, MIMOConfig
    from ce5g_tpu.estimators.blind import build_blind_tables as j_build
    from ce5g_tpu.physics.simulate import table_for as j_table_for

    if config == "bench":
        jcfg = ExperimentConfig(mimo=MIMOConfig(num_tx=4, num_rx=4))
    tcfg = port_cfg(jcfg)
    ref = j_build(jcfg, j_table_for(jcfg))
    got = build_blind_tables(tcfg, table_for(tcfg))
    assert got._fields == ref._fields
    for name, a, b in zip(ref._fields, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)
    assert got.f_dict.shape == (15, 599) and got.q_time.shape == (14, 5)
    table = table_for(tcfg)
    assert blind_tables_for(tcfg, table) is blind_tables_for(tcfg, table)  # cached


def test_estimate_priors_match_jax(jcfg, blind_case):
    jf, tf, jpri, margins, _ = blind_case
    tcfg = port_cfg(jcfg)
    got = estimate_priors(tf.rx_symbols, tf.tx_symbols[:, :, 0, :], tf.pilot_mask,
                          device_tables_for(tcfg, table_for(tcfg), "cpu"), tcfg.mimo.num_tx)
    clear = margins >= TIE_MARGIN
    print(f"frames clear of a tie: {int(clear.sum())} of {FRAMES}")
    np.testing.assert_array_equal(got.profile_idx.numpy()[clear], jpri["profile_idx"][clear])
    np.testing.assert_array_equal(got.doppler_hz.numpy()[clear], jpri["doppler_hz"][clear])
    np.testing.assert_allclose(got.sigma2.numpy(), jpri["sigma2"], rtol=PRIOR_RTOL)
    np.testing.assert_allclose(got.snr_db.numpy(), jpri["snr_db"], rtol=PRIOR_RTOL,
                               atol=PRIOR_RTOL)
    same = (got.profile_idx.numpy() == jpri["profile_idx"]) & (
        got.doppler_hz.numpy() == jpri["doppler_hz"])
    assert same[clear].all()
    w, jw = got.w_tap.numpy()[same], jpri["w_tap"][same]
    np.testing.assert_allclose(w, jw, rtol=PRIOR_RTOL, atol=PRIOR_RTOL * jw.max())


def test_mmse_full_est_matches_jax(jcfg, blind_case):
    """Within 1e-3 of the channel rms on the frames (all at SNR ≤ 5 dB)
    whose priors the port found as the JAX package did."""
    jf, tf, jpri, _, ref = blind_case
    got = estimate_batch(tf, cfg=port_cfg(jcfg), estimator="mmse_full_est", device="cpu")
    got = got.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    tcfg = port_cfg(jcfg)
    pri = estimate_priors(tf.rx_symbols, tf.tx_symbols[:, :, 0, :], tf.pilot_mask,
                          device_tables_for(tcfg, table_for(tcfg), "cpu"), tcfg.mimo.num_tx)
    pick = ((pri.profile_idx.numpy() == jpri["profile_idx"])
            & (pri.doppler_hz.numpy() == jpri["doppler_hz"])
            & (np.asarray(jf.params.snr_db) <= MAX_SNR_DB))
    print(f"frames compared: {int(pick.sum())} of {FRAMES}")
    assert pick.sum() >= 3
    axes = (1, 2, 3, 4)
    err = np.max(np.abs(got - ref), axis=axes)[pick]
    rms = np.sqrt(np.mean(np.abs(ref) ** 2, axis=axes))[pick]
    assert np.all(err <= EST_TOL * rms), err / rms


def test_mmse_full_est_ignores_params(jcfg):
    """The blindness guarantee (tests/test_blind.py in the JAX package):
    scrambled params give an identical output."""
    b = 4
    _, tf = simulate_both(jcfg, jax_params([2] * b, [100.0] * b, [15.0] * b, [0.05] * b),
                          seed=5)
    scrambled = tf._replace(params=tf.params._replace(
        profile_idx=torch.zeros(b, dtype=torch.int32),
        doppler_hz=torch.full((b,), 999.0),
        snr_db=torch.full((b,), -77.0),
    ))
    tcfg = port_cfg(jcfg)
    a = estimate_batch(tf, cfg=tcfg, estimator="mmse_full_est", device="cpu")
    c = estimate_batch(scrambled, cfg=tcfg, estimator="mmse_full_est", device="cpu")
    assert torch.equal(a, c)


@pytest.fixture(scope="module")
def blind_split(jcfg, tmp_path_factory):
    """A JAX-made 8-frame SIMO chunk as a .ce5g split with a manifest, both
    Wiener features as sidecars beside it, and each frame's JAX score
    margin."""
    from ce5g_torch.data.ce5g_format import write_ce5g
    from ce5g_tpu.data.generator import generate_chunk_fn
    from ce5g_tpu.eval.evaluate import _frames_from_arrays as j_frames

    root = tmp_path_factory.mktemp("blind")
    keys = jax.random.split(jax.random.key(11), FRAMES)
    arrays = {k: np.asarray(v) for k, v in generate_chunk_fn(jcfg)(keys).items()}
    frames = j_frames(arrays, np.arange(FRAMES), jcfg)
    write_ce5g(root / "test_chunk_00000.ce5g", arrays)
    (root / "test_manifest.json").write_text(json.dumps(
        {"split": "test", "total": FRAMES, "files": ["test_chunk_00000.ce5g"]}))
    for tag, est in (("wiener", "mmse_full"), ("bwiener", "mmse_full_est")):
        write_ce5g(root / f"test_{tag}_00000.ce5g",
                   {"H_wiener": np.asarray(_jax_estimator(jcfg, est)(frames))[:, :, 0, 0, :]})
        (root / f"test_{tag}_manifest.json").write_text(json.dumps(
            {"split": "test", "estimator": est, "files": [f"test_{tag}_00000.ce5g"]}))
    return root / "test_manifest.json", _jax_priors(jcfg, frames)[0]


def test_channel_dataset_reads_the_blind_feature(blind_split, tmp_path):
    from ce5g_torch.data import read_chunk, read_split
    from ce5g_torch.train import ChannelDataset

    blind_split = blind_split[0]
    root = blind_split.parent
    feature = {tag: read_chunk(root / f"test_{tag}_00000.ce5g")["H_wiener"]
               for tag in ("wiener", "bwiener")}
    blind = ChannelDataset(blind_split, wiener="bwiener")
    oracle = ChannelDataset(blind_split, wiener="wiener")
    idx = np.arange(3)
    h_std = blind.stats["h_std"]
    for ds, tag in ((blind, "bwiener"), (oracle, "wiener")):
        x = ds.make_batch(idx).inputs
        assert x.shape[-1] == 7
        np.testing.assert_allclose(x[..., 5] + 1j * x[..., 6], feature[tag][idx] / h_std,
                                   rtol=1e-6)
    np.testing.assert_array_equal(ChannelDataset(blind_split, wiener=True).make_batch(idx).inputs,
                                  oracle.make_batch(idx).inputs)
    with pytest.raises(FileNotFoundError, match="owiener_manifest"):
        ChannelDataset(blind_split, wiener="owiener")
    # an H_wiener array in the split wins for any tag (as in the JAX package)
    np.savez(tmp_path / "merged.npz", **read_split(blind_split), H_wiener=feature["bwiener"])
    np.testing.assert_array_equal(
        ChannelDataset(tmp_path / "merged.npz", wiener="wiener").make_batch(idx).inputs,
        blind.make_batch(idx).inputs)


def test_evaluate_estimators_mmse_full_est_matches_jax(jcfg, blind_split):
    """The NMSE of each frame at SNR ≤ 5 dB whose priors the port found
    as the JAX package did within 0.01 dB of the JAX package's. Above that the float32 rounding of either
    package's solve moves a frame's NMSE (−35 dB at 30 dB SNR) by up to
    4 dB, and this 8-frame split's mean by 0.023 dB (measured)."""
    from ce5g_torch.eval.evaluate import _frames_from_arrays

    path, jpri = blind_split
    from ce5g_tpu.eval.evaluate import evaluate_estimators as j_evaluate
    from ce5g_tpu.train import ChannelDataset as JChannelDataset
    from ce5g_torch.eval.evaluate import evaluate_estimators
    from ce5g_torch.train import ChannelDataset

    ref = j_evaluate(JChannelDataset(str(path)), jcfg, ("mmse_full_est",),
                     batch_size=FRAMES)["mmse_full_est"]
    ds = ChannelDataset(path)
    got = evaluate_estimators(ds, port_cfg(jcfg), ("mmse_full_est",), batch_size=FRAMES,
                              device="cpu")["mmse_full_est"]
    assert got["num_samples"] == ref["num_samples"] == FRAMES
    assert np.isfinite(got["per_sample"]).all()
    tcfg = port_cfg(jcfg)
    frames = _frames_from_arrays(ds.arrays, np.arange(FRAMES), tcfg, "cpu")
    pri = estimate_priors(frames.rx_symbols, frames.tx_symbols[:, :, 0, :], frames.pilot_mask,
                          device_tables_for(tcfg, table_for(tcfg), "cpu"), tcfg.mimo.num_tx)
    pick = ((pri.profile_idx.numpy() == jpri["profile_idx"])
            & (pri.doppler_hz.numpy() == jpri["doppler_hz"])
            & (ds.arrays["snr_db"] <= MAX_SNR_DB))
    assert pick.sum() >= 2
    np.testing.assert_allclose(10 * np.log10(got["per_sample"])[pick],
                               10 * np.log10(ref["per_sample"])[pick], rtol=0, atol=NMSE_TOL_DB)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mmse_full_est_card_matches_cpu(jcfg, blind_case, card):
    """The card's blind estimate (the HPD kernel at n = 75) against the
    CPU's, on the frames whose priors the two found alike."""
    _, tf, _, _, _ = blind_case
    tcfg = port_cfg(jcfg)
    out, pri = {}, {}
    for where in ("cpu", card):
        f = tf._replace(**{k: getattr(tf, k).to(where) for k in tf._fields[:-1]})
        out[str(where)] = estimate_batch(f, cfg=tcfg, estimator="mmse_full_est",
                                         device=where).cpu().numpy()
        p = estimate_priors(f.rx_symbols, f.tx_symbols[:, :, 0, :], f.pilot_mask,
                            device_tables_for(tcfg, table_for(tcfg), where), tcfg.mimo.num_tx)
        pri[str(where)] = (p.profile_idx.cpu().numpy(), p.doppler_hz.cpu().numpy())
    pick = (pri["cpu"][0] == pri["cuda"][0]) & (pri["cpu"][1] == pri["cuda"][1])
    assert pick.sum() >= 3
    axes = (1, 2, 3, 4)
    ref = out["cpu"][pick]
    err = np.max(np.abs(out["cuda"][pick] - ref), axis=axes)
    rms = np.sqrt(np.mean(np.abs(ref) ** 2, axis=axes))
    assert np.all(err <= EST_TOL * rms), err / rms
