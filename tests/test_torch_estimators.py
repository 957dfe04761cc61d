"""Port parity: ce5g_torch's estimators against ce5g_tpu's on the same frames.

Frames are simulated by ce5g_tpu, carried across with
``ce5g_torch.convert.frame_from_numpy``, and estimated by both packages
on the CPU. LS and diagonal MMSE agree elementwise within 1e-4 of the
channel's rms; mmse_full within 1e-3, because the Woodbury path's exact
cancellation (h − Φ·sol)/σ² amplifies differences in float32 summation
order between XLA and PyTorch. NMSE agrees within 0.01 dB.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ce5g_torch.convert import frame_from_numpy, profile_table_from_numpy
from ce5g_torch.estimators import estimate_batch
from ce5g_torch.utils import nmse_db

from _torch_parity import jax_params, port_cfg, simulate_both


def _jax_frames(jcfg, params, seed):
    from ce5g_tpu.physics import simulate_batch

    keys = jax.random.split(jax.random.key(seed), params.profile_idx.shape[0])
    return simulate_batch(keys, params, cfg=jcfg)


def _j_estimate(jcfg, frames, estimator, method="linear"):
    from ce5g_tpu.estimators.api import estimate_batch as j_estimate_batch

    fn = functools.partial(j_estimate_batch, cfg=jcfg, estimator=estimator, method=method)
    return np.asarray(jax.jit(fn)(frames))


def _db(h_true, h_est):
    h_true, h_est = np.asarray(h_true), np.asarray(h_est)
    err = np.mean(np.abs(h_true - h_est) ** 2) / np.mean(np.abs(h_true) ** 2)
    return 10 * np.log10(err)


@pytest.fixture(scope="module")
def small_frames(small_cfg):
    """Three JAX frames of mixed profile, Doppler, SNR and density. SNR
    stays ≤ 20 dB here: the Woodbury cancellation grows as 1/σ², and at
    25 dB even the JAX package's own two mmse_full branches (profile
    tables vs per-frame contractions) differ by 2.4e-3 of the channel rms
    on these frames, beyond the 1e-3 bound."""
    params = jax_params([0, 1, 2], [10.0, 100.0, 200.0], [5.0, 15.0, 20.0],
                        [0.05, 0.10, 0.15])
    jf = _jax_frames(small_cfg, params, seed=5)
    tf = frame_from_numpy(jax.tree.map(np.asarray, jf), device="cpu")
    return jf, tf


@pytest.mark.parametrize(
    "estimator,method,tol",
    [
        ("ls", "nearest", 1e-4),
        ("ls", "linear", 1e-4),
        ("mmse", "nearest", 1e-4),
        ("mmse", "linear", 1e-4),
        ("ls", "cubic", 1e-4),  # slot form
        ("mmse", "cubic", 1e-4),
        ("mmse_full", "linear", 1e-3),  # Woodbury cancellation, see module doc
    ],
)
def test_estimate_batch_matches_jax(small_cfg, small_frames, estimator, method, tol):
    jf, tf = small_frames
    ref = _j_estimate(small_cfg, jf, estimator, method)
    got = estimate_batch(tf, cfg=port_cfg(small_cfg), estimator=estimator,
                         method=method, device="cpu")
    assert got.shape == ref.shape
    h = np.asarray(jf.channel)
    rms = np.sqrt(np.mean(np.abs(h) ** 2, axis=(1, 2, 3, 4)))
    err = np.max(np.abs(got.numpy() - ref), axis=(1, 2, 3, 4))
    assert np.all(err <= tol * rms), err / rms
    assert abs(_db(h, got.numpy()) - _db(h, ref)) < 0.01


@pytest.mark.parametrize("time_rank", [5, None])
def test_mmse_full_per_frame_branch_matches_jax(small_cfg, small_frames, time_rank):
    """The per-frame E/D contractions (no profile tables) and full rank."""
    from ce5g_tpu.estimators.mmse import mmse_full_estimate as j_mmse_full
    from ce5g_tpu.physics import table_for as j_table_for
    from ce5g_torch.estimators.mmse import mmse_full_estimate

    jf, tf = small_frames
    table = j_table_for(small_cfg)
    s, k = small_cfg.ofdm.num_symbols, small_cfg.ofdm.num_used_subcarriers
    num_tx = small_cfg.mimo.num_tx
    f_all = jnp.asarray(table.freq_response)[jf.params.profile_idx]
    amp = jnp.asarray(table.amp_overwrite)[jf.params.profile_idx]

    def one(rx, tx, mask, snr, f, a, fd):
        return j_mmse_full(rx, tx[:, 0, :], mask, (s, k), num_tx, snr, f, a, fd,
                           small_cfg.ofdm.symbol_duration, time_rank=time_rank)

    ref = np.asarray(jax.jit(jax.vmap(one))(
        jf.rx_symbols, jf.tx_symbols, jf.pilot_mask, jf.params.snr_db, f_all, amp,
        jf.params.doppler_hz,
    ))
    got = mmse_full_estimate(
        tf.rx_symbols, tf.tx_symbols[:, :, 0, :], tf.pilot_mask, num_tx,
        tf.params.snr_db, torch.from_numpy(np.array(f_all)),
        torch.from_numpy(np.array(amp)), tf.params.doppler_hz,
        small_cfg.ofdm.symbol_duration, time_rank=time_rank,
    ).numpy()
    h = np.asarray(jf.channel)
    rms = np.sqrt(np.mean(np.abs(h) ** 2, axis=(1, 2, 3, 4)))
    err = np.max(np.abs(got - ref), axis=(1, 2, 3, 4))
    assert np.all(err <= 1e-3 * rms), err / rms


def test_whole_slice_matches_jax(cfg):
    """Default 4×4 numerology, 4 frames, the same draws end to end:
    simulate → estimate → NMSE agree within 0.01 dB."""
    from ce5g_tpu import MIMOConfig

    cfg4 = dataclasses.replace(cfg, mimo=MIMOConfig(num_tx=4, num_rx=4))
    params = jax_params([2, 2, 1, 0], [200.0, 200.0, 100.0, 50.0],
                        [10.0, 10.0, 20.0, 0.0], [0.10, 0.10, 0.05, 0.10])
    jf, tf = simulate_both(cfg4, params, seed=21)
    for estimator in ("ls", "mmse_full"):
        ref_db = _db(jf.channel, _j_estimate(cfg4, jf, estimator))
        got = estimate_batch(tf, cfg=port_cfg(cfg4), estimator=estimator, device="cpu")
        got_db = float(nmse_db(tf.channel, got))
        assert abs(got_db - ref_db) < 0.01, (estimator, got_db, ref_db)


@pytest.fixture(scope="module")
def full_frames(cfg):
    """Four JAX frames at the default numerology (2×2, 14 × 599), EVA at
    the parity study's 50 Hz, with mixed SNR and density up to 20%."""
    jcfg = dataclasses.replace(
        cfg, pilots=dataclasses.replace(cfg.pilots, max_density=0.25)
    )
    params = jax_params([1, 1, 0, 2], [50.0] * 4, [5.0, 15.0, 25.0, 15.0],
                        [0.10, 0.20, 0.05, 0.10])
    jf = _jax_frames(jcfg, params, seed=9)
    return jcfg, jf, frame_from_numpy(jax.tree.map(np.asarray, jf), device="cpu")


@pytest.mark.parametrize("estimator", ["ls", "mmse"])
def test_cubic_full_numerology_matches_jax(full_frames, estimator):
    jcfg, jf, tf = full_frames
    ref = _j_estimate(jcfg, jf, estimator, "cubic")
    got = estimate_batch(tf, cfg=port_cfg(jcfg), estimator=estimator, method="cubic",
                         device="cpu").numpy()
    h = np.asarray(jf.channel)
    rms = np.sqrt(np.mean(np.abs(h) ** 2, axis=(1, 2, 3, 4)))
    err = np.max(np.abs(got - ref), axis=(1, 2, 3, 4))
    assert np.all(err <= 1e-4 * rms), err / rms
    assert abs(_db(h, got) - _db(h, ref)) < 0.01


@pytest.mark.parametrize("method", ["nearest", "linear"])
@pytest.mark.parametrize("estimator", ["ls", "mmse"])
def test_slot_branch_without_mask_matches_jax(small_cfg, small_frames, estimator, method):
    """ls_estimate / mmse_diag_estimate with no pilot mask take the slot
    form for every method, as ce5g_tpu's do (ls.py:81-83, mmse.py:140-143)."""
    from ce5g_tpu.estimators.ls import ls_estimate as j_ls
    from ce5g_tpu.estimators.mmse import mmse_diag_estimate as j_mmse
    from ce5g_torch.estimators import ls_estimate, mmse_diag_estimate

    jf, tf = small_frames
    grid = (small_cfg.ofdm.num_symbols, small_cfg.ofdm.num_used_subcarriers)
    num_tx = small_cfg.mimo.num_tx

    def one(rx, tx, pos, valid, snr):
        if estimator == "ls":
            return j_ls(rx, tx[:, 0, :], pos, valid, grid, num_tx, method)
        return j_mmse(rx, tx[:, 0, :], pos, valid, grid, num_tx, snr, method)

    ref = np.asarray(jax.jit(jax.vmap(one))(
        jf.rx_symbols, jf.tx_symbols, jf.pilot_positions, jf.pilot_valid, jf.params.snr_db
    ))
    args = (tf.rx_symbols, tf.tx_symbols[:, :, 0, :], tf.pilot_positions, tf.pilot_valid,
            grid, num_tx)
    if estimator == "ls":
        got = ls_estimate(*args, method)
    else:
        got = mmse_diag_estimate(*args, tf.params.snr_db, method)
    h = np.asarray(jf.channel)
    rms = np.sqrt(np.mean(np.abs(h) ** 2, axis=(1, 2, 3, 4)))
    err = np.max(np.abs(got.numpy() - ref), axis=(1, 2, 3, 4))
    assert np.all(err <= 1e-4 * rms), err / rms
    # with the mask the grid form gives the same estimate (nearest exactly;
    # linear up to the row-scan's rare same-row third neighbour)
    masked = (ls_estimate(*args, method, pilot_mask=tf.pilot_mask) if estimator == "ls"
              else mmse_diag_estimate(*args, tf.params.snr_db, method,
                                      pilot_mask=tf.pilot_mask))
    assert abs(_db(h, masked.numpy()) - _db(h, got.numpy())) < 0.05


def test_auto_time_rank_and_bessel_match_jax(cfg):
    from ce5g_tpu import ChannelConfig
    from ce5g_tpu.estimators.api import auto_time_rank as j_rank
    from ce5g_tpu.estimators.mmse import bessel_j0 as j_j0
    from ce5g_torch.estimators import auto_time_rank, bessel_j0

    for doppler in [(10.0,), (200.0,), (500.0,), (5000.0,)]:
        c = dataclasses.replace(cfg, channel=ChannelConfig(doppler_hz=doppler))
        assert auto_time_rank(port_cfg(c)) == j_rank(c)
    x = np.linspace(-20, 20, 401).astype(np.float32)
    np.testing.assert_allclose(
        bessel_j0(torch.from_numpy(x)).numpy(), np.asarray(j_j0(jnp.asarray(x))), atol=1e-6
    )


def test_convert_profile_table(cfg):
    from ce5g_tpu.physics import table_for as j_table_for
    from ce5g_torch.physics import table_for

    ported = profile_table_from_numpy(j_table_for(cfg))
    own = table_for(port_cfg(cfg))
    for f in dataclasses.fields(own):
        if not f.name.startswith("_"):
            np.testing.assert_array_equal(getattr(ported, f.name), getattr(own, f.name))


@pytest.mark.parametrize("estimator", ["ls", "mmse_full"])
def test_estimate_frame_is_batch_of_one(small_cfg, small_frames, estimator):
    from ce5g_torch.estimators import estimate_frame
    from ce5g_torch.physics import Frame, FrameParams

    _, tf = small_frames
    cfg = port_cfg(small_cfg)
    one = Frame(*(x[1] for x in tf[:-1]), FrameParams(*(x[1] for x in tf.params)))
    got = estimate_frame(one, cfg=cfg, estimator=estimator, device="cpu")
    ref = estimate_batch(tf, cfg=cfg, estimator=estimator, device="cpu")[1]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_estimator_rules(small_cfg, small_frames):
    _, tf = small_frames
    cfg = port_cfg(small_cfg)
    # the blind estimator runs (its parity: tests/test_torch_blind.py)
    h = estimate_batch(tf, cfg=cfg, estimator="mmse_full_est", device="cpu")
    assert tuple(h.shape) == tuple(tf.channel.shape) and bool(torch.isfinite(h).all())
    # cubic takes the slot form (no longer a later slice)
    h = estimate_batch(tf, cfg=cfg, estimator="ls", method="cubic", device="cpu")
    assert tuple(h.shape) == tuple(tf.channel.shape) and bool(torch.isfinite(h).all())
    with pytest.raises(ValueError, match="Unknown interpolation method"):
        estimate_batch(tf, cfg=cfg, estimator="ls", method="spline", device="cpu")
    with pytest.raises(ValueError):
        estimate_batch(tf, cfg=cfg, estimator="zf", device="cpu")


def test_mmse_full_float64_reference(small_cfg, small_frames):
    """The float64 run of the plain mmse_full path that chip_smoke.py holds
    the card's result to: complex128, and within the float32 bound of both
    packages' float32 results."""
    import chip_smoke

    jf, tf = small_frames
    cfg = port_cfg(small_cfg)
    h64 = chip_smoke.mmse_full_float64(cfg, tf)
    assert h64.dtype == torch.complex128
    h32 = estimate_batch(tf, cfg=cfg, estimator="mmse_full", device="cpu")
    ref = _j_estimate(small_cfg, jf, "mmse_full")
    h = np.asarray(jf.channel)
    rms = np.sqrt(np.mean(np.abs(h) ** 2, axis=(1, 2, 3, 4)))
    for got in (h32.numpy(), ref):
        err = np.max(np.abs(got - h64.numpy()), axis=(1, 2, 3, 4))
        assert np.all(err <= 1e-3 * rms), err / rms
