"""Port parity: the time-domain chain and the Wiener-prior API.

OFDM modulation, dense Jakes fading, the time-varying FIR and the whole
time-domain frame are held against ce5g_tpu on the same inputs: the JAX
package's own draws (``jax_td_draws``: simulate_frame_time_domain's keys
and sub-splits) or numpy arrays made from a seed. Tolerances: 1e-5 of the
rms where one float32 operation separates the packages (FFT, FIR, Jakes
sum), 1e-4 of the rms for a whole frame, as test_torch_physics.py holds
the frequency-domain path.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ce5g_torch.physics import (
    FrameDraws,
    FrameParams,
    dense_fading,
    demodulate,
    draw_frames,
    jakes_oscillator_params,
    modulate,
    simulate_batch_time_domain,
    simulate_frame_time_domain,
    time_domain_apply,
)
from ce5g_torch.physics.profiles import MAX_PATHS, PROFILE_INDEX

from _torch_parity import assert_close_to_power, jax_params, jax_td_draws, port_cfg

FS = 15.36e6


def _complex(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _rel_err(actual, expected):
    a, e = np.asarray(actual), np.asarray(expected)
    return np.max(np.abs(a - e)) / np.sqrt(np.mean(np.abs(e) ** 2))


@pytest.mark.parametrize("numerology", ["small", "full"])
def test_modulate_demodulate_match_jax(small_cfg, cfg, numerology):
    from ce5g_tpu.physics.ofdm import demodulate as j_demodulate
    from ce5g_tpu.physics.ofdm import modulate as j_modulate

    ofdm = (small_cfg if numerology == "small" else cfg).ofdm
    rng = np.random.default_rng(0)
    x = _complex(rng, 2, 3, ofdm.num_symbols, ofdm.num_used_subcarriers)
    t = modulate(torch.tensor(x), ofdm)
    assert t.shape == (2, 3, ofdm.num_symbols, ofdm.samples_per_symbol)
    assert _rel_err(t, j_modulate(jnp.asarray(x), ofdm)) < 1e-5
    sig = _complex(rng, 2, ofdm.num_symbols, ofdm.samples_per_symbol)
    assert _rel_err(demodulate(torch.tensor(sig), ofdm), j_demodulate(jnp.asarray(sig), ofdm)) < 1e-5
    # the round trip gives the symbols back
    assert _rel_err(demodulate(t, ofdm), x) < 1e-5


@pytest.mark.parametrize("n, rt", [(3000, (2, 3)), (15344, (2, 2))])
def test_dense_fading_matches_jax(n, rt):
    """On the JAX package's oscillator draws; 15 344 is a full frame (1024
    FFT, CP 72, 14 symbols), 3000 a partial last block."""
    from ce5g_tpu.physics.jakes import dense_fading as j_dense_fading
    from ce5g_tpu.physics.jakes import jakes_oscillator_params as j_params

    r, t = rt
    key = jax.random.key(n)
    amp = np.linspace(1.0, 0.1, MAX_PATHS).astype(np.float32)
    want = j_dense_fading(key, 200.0, jnp.asarray(amp), n, FS, r, t)
    angles, phases = (torch.tensor(np.asarray(a))[None] for a in j_params(key, MAX_PATHS, r, t, 20))
    got = dense_fading(angles, phases, torch.tensor([200.0]), torch.tensor(amp)[None], n, FS)
    assert got.shape == (1, n, r, t, MAX_PATHS)
    assert _rel_err(got[0], want) < 1e-5


def test_oscillator_draws_are_the_frames_draws(small_cfg):
    """draw_frames takes its Jakes angles and phases from
    jakes_oscillator_params, in one order with the other draws; the
    time-domain draws differ from the frequency-domain ones only in the
    noise, drawn per received sample."""
    cfg = port_cfg(small_cfg)
    params = FrameParams(torch.zeros(3, dtype=torch.int32), torch.full((3,), 50.0),
                         torch.full((3,), 10.0), torch.full((3,), 0.1))
    fd = draw_frames(torch.Generator().manual_seed(1), params, cfg, device="cpu")
    td = draw_frames(torch.Generator().manual_seed(1), params, cfg, device="cpu",
                     time_domain=True)
    for a, b in zip(fd[:4], td[:4]):
        assert torch.equal(a, b)
    n = cfg.ofdm.num_symbols * cfg.ofdm.samples_per_symbol
    assert td.noise_re.shape == td.noise_im.shape == (3, cfg.mimo.num_rx, n)
    gen = torch.Generator().manual_seed(7)
    angles, phases = jakes_oscillator_params(gen, MAX_PATHS, 2, 2, 20, "cpu")
    assert angles.shape == phases.shape == (MAX_PATHS, 2, 2, 20)
    assert float(angles.min()) >= 0.0 and float(phases.max()) < 2 * np.pi
    assert not torch.equal(angles, phases)


@pytest.mark.parametrize("profile", ["EPA", "ETU"])
def test_time_domain_apply_matches_jax(cfg, profile):
    """The FIR on a batch that mixes ``profile`` with EVA, each frame held to
    the JAX package's with its own tap delays."""
    from ce5g_tpu.physics import table_for
    from ce5g_tpu.physics.mimo import time_domain_apply as j_apply

    table = table_for(cfg)
    rng = np.random.default_rng(3)
    n, r, t = 600, 2, 3
    pis = [PROFILE_INDEX[profile], PROFILE_INDEX["EVA"]]
    x = _complex(rng, 2, t, n)
    g = _complex(rng, 2, n, r, t, MAX_PATHS)
    delays = table.delay_samples[pis]
    valid = table.path_valid[pis]
    got = time_domain_apply(torch.tensor(x), torch.tensor(g), torch.tensor(delays),
                            torch.tensor(valid))
    assert got.shape == (2, r, n)
    for i in range(2):
        want = j_apply(jnp.asarray(x[i]), jnp.asarray(g[i]), jnp.asarray(delays[i]),
                       jnp.asarray(valid[i]))
        assert _rel_err(got[i], want) < 1e-5
    # the first max-delay outputs see only the paths that have arrived
    d_max = int(delays[0].max())
    assert d_max > 0 and _rel_err(got[0, :, d_max:], np.asarray(
        j_apply(jnp.asarray(x[0]), jnp.asarray(g[0]), jnp.asarray(delays[0]),
                jnp.asarray(valid[0])))[:, d_max:]) < 1e-5


def _simulate_td_both(jcfg, params, seed):
    from ce5g_tpu.physics import simulate_frame_time_domain as j_simulate

    b = params.profile_idx.shape[0]
    keys = jax.random.split(jax.random.key(seed), b)
    jf = jax.jit(jax.vmap(functools.partial(j_simulate, cfg=jcfg)))(keys, params)
    tf = simulate_batch_time_domain(
        jax_td_draws(keys, jcfg), FrameParams(*(torch.tensor(np.asarray(x)) for x in params)),
        cfg=port_cfg(jcfg), device="cpu")
    return jf, tf


@pytest.mark.parametrize("numerology", ["small", "full_4x4_etu"])
def test_simulate_time_domain_matches_jax(small_cfg, numerology):
    """Whole frames on the JAX package's draws: the pilot pattern and the
    transmit grid exactly, channel and rx within 1e-4 of the rms."""
    from ce5g_tpu import ExperimentConfig, MIMOConfig

    if numerology == "small":
        jcfg = small_cfg
        params = jax_params([0, 1, 2], [0.0, 100.0, 200.0], [40.0, 10.0, 25.0],
                            [0.05, 0.10, 0.15])
    else:
        jcfg = ExperimentConfig(mimo=MIMOConfig(num_tx=4, num_rx=4))
        params = jax_params([PROFILE_INDEX["ETU"]] * 2, [200.0] * 2, [10.0] * 2, [0.1] * 2)
    jf, tf = _simulate_td_both(jcfg, params, seed=5)
    np.testing.assert_array_equal(tf.pilot_mask.numpy(), np.asarray(jf.pilot_mask))
    np.testing.assert_array_equal(tf.pilot_positions.numpy(), np.asarray(jf.pilot_positions))
    np.testing.assert_allclose(tf.tx_symbols.numpy(), np.asarray(jf.tx_symbols), atol=1e-6)
    assert tf.channel.shape == jf.channel.shape and tf.rx_symbols.shape == jf.rx_symbols.shape
    assert_close_to_power(tf.channel, jf.channel, 1e-4)
    assert_close_to_power(tf.rx_symbols, jf.rx_symbols, 1e-4)


def test_time_domain_chain_static_channel(small_cfg):
    """tests/test_physics.py:279 on the port: a static EPA channel at 40 dB
    gives rx ≈ H·x, the CP covering EPA's delays."""
    params = FrameParams(torch.tensor(PROFILE_INDEX["EPA"], dtype=torch.int32),
                         torch.tensor(0.0), torch.tensor(40.0), torch.tensor(0.1))
    cfg = port_cfg(small_cfg)
    draws = draw_frames(torch.Generator().manual_seed(6),
                        FrameParams(*(x[None] for x in params)), cfg, device="cpu",
                        time_domain=True)
    f = simulate_frame_time_domain(FrameDraws(*(x[0] for x in draws)), params, cfg=cfg,
                                   device="cpu")
    y_pred = torch.einsum("srtk,stk->srk", f.channel, f.tx_symbols)
    err = float((f.rx_symbols - y_pred).abs().pow(2).mean() / y_pred.abs().pow(2).mean())
    assert err < 2e-3


def test_time_domain_draws_are_checked(small_cfg):
    """Frequency-domain draws on the time-domain chain raise."""
    cfg = port_cfg(small_cfg)
    params = FrameParams(torch.zeros(1, dtype=torch.int32), torch.ones(1), torch.ones(1),
                         torch.full((1,), 0.1))
    draws = draw_frames(torch.Generator().manual_seed(0), params, cfg, device="cpu")
    with pytest.raises(ValueError, match="time_domain=True"):
        simulate_batch_time_domain(draws, params, cfg=cfg, device="cpu")


# --------------------------------------------------------- Wiener-prior API
def _prior_inputs(cfg, density=0.05, seed=6):
    from ce5g_tpu.physics import make_pattern, table_for

    table = table_for(cfg)
    pat = make_pattern(jax.random.key(seed), 14, 599, density, "scattered")
    pi = PROFILE_INDEX["ETU"]
    return (np.asarray(table.freq_response[pi]), np.asarray(table.amp_overwrite[pi]),
            np.asarray(pat.positions), np.asarray(pat.valid))


def _both_priors(fm, amp, doppler, positions, valid):
    from ce5g_tpu.estimators import build_wiener_prior as j_build
    from ce5g_torch.estimators import build_wiener_prior

    args = (doppler, 1096 / FS, 14)
    jp = j_build(jnp.asarray(fm), jnp.asarray(amp), *args, jnp.asarray(positions),
                 jnp.asarray(valid))
    tp = build_wiener_prior(torch.tensor(fm), torch.tensor(amp), *args,
                            torch.tensor(positions), torch.tensor(valid))
    return jp, tp


def test_wiener_prior_matches_jax(cfg):
    """ΦΦᴴ and U·λ·Uᵀ (invariant to the eigenvectors' signs) against the
    JAX package's; f_mat and w_path exactly."""
    fm, amp, positions, valid = _prior_inputs(cfg)
    jp, tp = _both_priors(fm, amp, 100.0, positions, valid)
    np.testing.assert_array_equal(tp.f_mat.numpy(), np.asarray(jp.f_mat))
    np.testing.assert_allclose(tp.w_path.numpy(), np.asarray(jp.w_path), rtol=1e-7)
    phi_j = np.asarray(jp.phi)
    assert _rel_err(tp.phi @ tp.phi.mH, phi_j @ phi_j.conj().T) < 1e-5
    u_j = np.asarray(jp.u_scaled)
    assert _rel_err(tp.u_scaled @ tp.u_scaled.T, u_j @ u_j.T) < 1e-5


def test_wiener_solve_matches_dense_and_jax(cfg):
    """tests/test_estimators.py:202-233 on the port: the Woodbury solve
    equals the dense P × P solve (atol 2e-3, as there) and the JAX
    package's within 1e-4 of the rms."""
    from ce5g_tpu.estimators.mmse import wiener_solve as j_solve
    from ce5g_torch.estimators import wiener_solve

    fm, amp, positions, valid = _prior_inputs(cfg)
    jp, tp = _both_priors(fm, amp, 100.0, positions, valid)
    rng = np.random.default_rng(1)
    p = positions.shape[0]
    h = ((rng.normal(size=p) + 1j * rng.normal(size=p)) * valid).astype(np.complex64)
    sigma2 = 0.05
    x = wiener_solve(tp, torch.tensor(h), sigma2, obs_scale=2.0)
    phi = tp.phi.numpy().astype(np.complex128) * np.sqrt(2.0)
    x_dense = np.linalg.solve(phi @ phi.conj().T + sigma2 * np.eye(p), h)
    np.testing.assert_allclose(x.numpy(), x_dense, atol=2e-3)
    assert _rel_err(x, j_solve(jp, jnp.asarray(h), sigma2, 2.0)) < 1e-4
    # leading dims are one block of right-hand sides
    hh = np.stack([h, 2 * h, -h])
    xx = wiener_solve(tp, torch.tensor(hh), sigma2, obs_scale=2.0)
    assert _rel_err(xx[1], 2 * x) < 1e-5


def test_pilot_formulation_equals_mmse_full(cfg):
    """tests/test_estimators.py:235-258 on the port: mmse_full_estimate's
    masked-grid contraction equals build_wiener_prior → wiener_solve →
    wiener_reconstruct (atol 5e-3 of the mean |h|, as there: the grid form
    carries a 1e-4 ridge on R_t), and the reconstruction equals the JAX
    package's."""
    from ce5g_tpu.estimators import build_wiener_prior as j_build
    from ce5g_tpu.estimators.mmse import wiener_reconstruct as j_reconstruct
    from ce5g_tpu.physics import table_for
    from ce5g_torch.estimators import (
        build_wiener_prior,
        ls_at_pilots,
        mmse_full_estimate,
        wiener_reconstruct,
        wiener_solve,
    )
    from ce5g_torch.physics import simulate_batch

    from _torch_parity import jax_draws

    keys = jax.random.split(jax.random.key(11), 1)
    jparams = jax_params([PROFILE_INDEX["EVA"]], [70.0], [10.0], [0.1])
    pcfg = port_cfg(cfg)
    f = simulate_batch(jax_draws(keys, cfg),
                       FrameParams(*(torch.tensor(np.asarray(x)) for x in jparams)),
                       cfg=pcfg, device="cpu")
    s, k, num_tx = cfg.ofdm.num_symbols, cfg.ofdm.num_used_subcarriers, cfg.mimo.num_tx
    table = table_for(cfg)
    pi = PROFILE_INDEX["EVA"]
    fm = torch.tensor(table.freq_response[pi])
    amp = torch.tensor(table.amp_overwrite[pi])
    dop, tsym = f.params.doppler_hz[0], pcfg.ofdm.symbol_duration

    h_grid = mmse_full_estimate(f.rx_symbols, f.tx_symbols[:, :, 0, :], f.pilot_mask, num_tx,
                                f.params.snr_db, fm[None], amp[None], f.params.doppler_hz,
                                tsym)[0]
    h_p = ls_at_pilots(f.rx_symbols.transpose(1, 2), f.tx_symbols[:, :, 0, :],
                       f.pilot_positions, f.pilot_valid)[0]  # (R, P)
    positions, valid = f.pilot_positions[0], f.pilot_valid[0]
    prior = build_wiener_prior(fm, amp, float(dop), tsym, s, positions, valid)
    sigma2 = max(num_tx * float(prior.w_path.sum()) / 10 ** (float(f.params.snr_db[0]) / 10),
                 1e-8)
    x = wiener_solve(prior, h_p * valid, sigma2, float(num_tx))
    h_phi = wiener_reconstruct(prior, x, positions, (s, k)).transpose(0, 1)  # (S, R, K)
    scale = float(h_phi.abs().mean())
    np.testing.assert_allclose(h_grid[:, :, 0, :].numpy(), h_phi.numpy(), atol=5e-3 * scale)

    jp = j_build(jnp.asarray(fm.numpy()), jnp.asarray(amp.numpy()), float(dop), tsym, s,
                 jnp.asarray(positions.numpy()), jnp.asarray(valid.numpy()))
    want = j_reconstruct(jp, jnp.asarray(x.numpy()), jnp.asarray(positions.numpy()), (s, k))
    assert _rel_err(wiener_reconstruct(prior, x, positions, (s, k)), want) < 1e-4


def test_estimate_covariance_matches_jax():
    from ce5g_tpu.estimators import estimate_covariance as j_cov
    from ce5g_torch.estimators import estimate_covariance

    h = _complex(np.random.default_rng(2), 3, 5, 7)
    got = estimate_covariance(torch.tensor(h))
    assert got.shape == (7, 7)
    assert _rel_err(got, j_cov(jnp.asarray(h))) < 1e-5
    np.testing.assert_allclose(got.numpy(), np.cov(h.reshape(-1, 7), rowvar=False).T,
                               rtol=1e-4, atol=1e-5)


def test_put_complex():
    from ce5g_torch.utils import put_complex

    x = _complex(np.random.default_rng(4), 3, 2)
    t = put_complex(x, device="cpu")
    assert t.dtype == torch.complex64 and np.array_equal(t.numpy(), x)
    assert put_complex(np.arange(3.0, dtype=np.float32), device="cpu").dtype == torch.float32


# ------------------------------------------------ chip_smoke's anchors
TD_ANCHOR_FRAMES = 256
TD_ANCHOR_BATCH = 8


def _jax_td_bench_nmse():
    """Per-frame NMSE of mmse_full, ls and ls:cubic on JAX time-domain
    frames at the bench config (4×4, ETU, 200 Hz, 10 dB, 10% pilots), in
    float32 on the CPU, from keys split from key(0)."""
    from ce5g_tpu import ExperimentConfig, MIMOConfig
    from ce5g_tpu.estimators.api import estimate_batch
    from ce5g_tpu.physics import simulate_frame_time_domain as j_simulate

    jcfg = ExperimentConfig(mimo=MIMOConfig(num_tx=4, num_rx=4))
    b = TD_ANCHOR_BATCH
    params = jax_params([PROFILE_INDEX["ETU"]] * b, [200.0] * b, [10.0] * b, [0.1] * b)
    simulate = jax.jit(jax.vmap(functools.partial(j_simulate, cfg=jcfg)))
    estimators = {name: jax.jit(functools.partial(estimate_batch, cfg=jcfg, estimator=est,
                                                  method=method))
                  for name, est, method in (("mmse_full", "mmse_full", "linear"),
                                            ("ls", "ls", "linear"),
                                            ("ls:cubic", "ls", "cubic"))}
    keys = jax.random.split(jax.random.key(0), TD_ANCHOR_FRAMES)
    out = {name: [] for name in estimators}
    for start in range(0, TD_ANCHOR_FRAMES, b):
        frames = simulate(keys[start:start + b], params)
        h = np.asarray(frames.channel)
        power = np.mean(np.abs(h) ** 2, axis=(1, 2, 3, 4))
        for name, fn in estimators.items():
            err = np.mean(np.abs(h - np.asarray(fn(frames))) ** 2, axis=(1, 2, 3, 4))
            out[name].append(err / power)
    return {name: np.concatenate(v) for name, v in out.items()}


@pytest.mark.slow  # 256 full-size 4×4 frames through the JAX package on the CPU
def test_time_domain_anchors_are_the_jax_package():
    """chip_smoke.py phase 15's time-domain anchors: the JAX package's mean
    NMSE and its σ (dB) on 256 frames at the bench config. Run with
    ``pytest tests/test_torch_time_domain.py -m slow``."""
    import chip_smoke

    for name, per_frame in _jax_td_bench_nmse().items():
        mean = per_frame.mean()
        sigma = per_frame.std(ddof=1) / np.sqrt(len(per_frame))
        mean_db, sigma_db = 10 * np.log10(mean), 10 / np.log(10) * sigma / mean
        print(f"{name}: {mean_db:.4f} dB, σ {sigma_db:.4f} dB")
        assert chip_smoke.TD_ANCHORS_DB[name] == (round(mean_db, 3), round(sigma_db, 3)), name
