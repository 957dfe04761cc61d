"""Port parity of measured BER: QAM, the MIMO equalisers, the QAM frame,
the per-frame bit-error counts and the metrics helpers, ce5g_torch
against ce5g_tpu on the same inputs on the CPU.

Tolerances:
  * QAM symbols and bits are equal exactly (the same tables, the same
    first-minimum tie rule);
  * equalised symbols within 1e-5 of their rms where the RE's system is
    well conditioned, the bound growing with its condition number;
  * QAM frames: payload bits, pilot mask and TX grid exactly, channel
    and received grid within 1e-5 of their rms (float32 summation order);
  * bit-error counts per frame within 5e-4 of the data bits counted
    (≈16 of a SIMO frame's 31 868): on the same inputs only a symbol that
    sits on a decision boundary can flip, when float32 rounding of the
    channel estimate moves x̂ across it (two bits of a frame seen for
    mmse_full at 10 dB, none for ls).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ce5g_torch.physics import FrameParams

from _torch_parity import assert_close_to_power, jax_params, jax_qam_draws, port_cfg, simulate_both

BIT_TOL = 5e-4


def _simo_cfg():
    from ce5g_tpu import ExperimentConfig, MIMOConfig

    return ExperimentConfig(mimo=MIMOConfig(num_tx=1, num_rx=2))


def _port_params(params):
    return FrameParams(*(torch.tensor(np.asarray(x)) for x in params))


@pytest.mark.parametrize("m", [4, 16, 64])
def test_qam_round_trip_and_jax_symbols(m):
    from ce5g_tpu.utils import qam as jqam
    from ce5g_torch.utils import qam

    k = qam.bits_per_symbol(m)
    bits = np.random.default_rng(m).integers(0, 2, size=(3, 240 * k)).astype(np.int32)
    syms = qam.qam_modulate(torch.from_numpy(bits), m)
    assert syms.dtype == torch.complex64 and syms.shape == (3, 240)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(jqam.qam_modulate(bits, m)))
    np.testing.assert_array_equal(qam.qam_demodulate(syms, m).numpy(), bits)
    # noisy symbols demodulate as JAX's do, bit for bit
    rng = np.random.default_rng(100 + m)
    noisy = (syms.numpy() + 0.2 * (rng.standard_normal(syms.shape)
                                   + 1j * rng.standard_normal(syms.shape))).astype(np.complex64)
    np.testing.assert_array_equal(qam.qam_demodulate(torch.from_numpy(noisy), m).numpy(),
                                  np.asarray(jqam.qam_demodulate(noisy, m)))


def test_qam_ties_take_the_first_point_and_unknown_orders_raise():
    from ce5g_tpu.utils import qam as jqam
    from ce5g_torch.utils import qam

    # 0 is equally far from all four QPSK points; ±1 from two of them
    ties = np.array([0.0, 1.0, -1.0, 1j, -1j], np.complex64)
    np.testing.assert_array_equal(qam.qam_demodulate(torch.from_numpy(ties), 4).numpy(),
                                  np.asarray(jqam.qam_demodulate(ties, 4)))
    with pytest.raises(NotImplementedError):
        qam.qam_modulate(torch.zeros(8, dtype=torch.int32), 8)
    with pytest.raises(NotImplementedError):
        qam.qam_demodulate(torch.zeros(4, dtype=torch.complex64), 32)


@pytest.mark.parametrize("method,noise_var", [("zf", 0.01), ("mmse", 0.01), ("mmse", 0.3)])
def test_equalize_channel_matches_jax(method, noise_var):
    """ZF and MMSE on 4×4 orthogonal-pilot frames (full H, per-antenna
    grids), per RE within 1e-5 of the rms of the equalised symbols where
    the RE's system HᴴH + λI has condition ≤ 10, the bound growing with
    the condition beyond: a float32 solve's error does (ZF at λ = 1e-8
    meets conditions up to 6e5 on true Rayleigh channels; the packages
    then differ by ≤ 2.3e-7 · condition · rms, and each is as far from a
    float64 solve)."""
    from ce5g_tpu import ExperimentConfig, MIMOConfig
    from ce5g_tpu.estimators import equalize_channel as j_equalize
    from ce5g_torch.estimators import equalize_channel

    jcfg = ExperimentConfig(mimo=MIMOConfig(num_tx=4, num_rx=4))
    jf, tf = simulate_both(jcfg, jax_params([1, 2], [50.0, 200.0], [20.0, 30.0], [0.1, 0.1]),
                           seed=2, orthogonal=True)
    rx, h = np.array(jf.rx_symbols), np.array(jf.channel)
    expect = np.asarray(j_equalize(rx, h, method, noise_var))
    got = equalize_channel(torch.from_numpy(rx), torch.from_numpy(h), method, noise_var)
    assert got.dtype == torch.complex64 and got.shape == expect.shape == (2, 14, 4, 599)
    hk = np.moveaxis(h, -1, -3).astype(np.complex128)  # (B, S, K, R, T)
    lam = 1e-8 if method == "zf" else noise_var
    cond = np.linalg.cond(np.conj(np.swapaxes(hk, -1, -2)) @ hk + lam * np.eye(4))  # (B, S, K)
    rms = np.sqrt(np.mean(np.abs(expect) ** 2))
    bound = 1e-5 * rms * np.maximum(1.0, cond / 10.0)[:, :, None, :]
    assert np.all(np.abs(got.numpy() - expect) <= bound)
    with pytest.raises(ValueError, match="Unknown equalization"):
        equalize_channel(tf.rx_symbols, tf.channel, "ml")


@pytest.fixture(scope="module")
def qam_frames():
    """Four SIMO QAM frames (EVA, 50 Hz, 5%) of JAX keys, simulated by
    both packages: (jcfg, keys, params, JAX frames and bits, port frames
    and bits)."""
    from ce5g_tpu.eval.ber import simulate_qam_frame
    from ce5g_torch.eval.ber import simulate_qam_batch

    jcfg = _simo_cfg()
    keys = jax.random.split(jax.random.key(3), 4)
    params = jax_params([1] * 4, [50.0] * 4, [0.0, 5.0, 10.0, 15.0], [0.05] * 4)
    jf, jbits = jax.jit(jax.vmap(functools.partial(simulate_qam_frame, cfg=jcfg)))(keys, params)
    tf, tbits = simulate_qam_batch(jax_qam_draws(keys, jcfg), _port_params(params),
                                   cfg=port_cfg(jcfg), device="cpu")
    return jcfg, keys, params, (jf, jbits), (tf, tbits)


def test_simulate_qam_batch_matches_jax(qam_frames):
    _, _, _, (jf, jbits), (tf, tbits) = qam_frames
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    for name in ("tx_symbols", "pilot_mask", "pilot_positions", "pilot_valid", "num_pilots"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                      err_msg=name)
    for name in ("channel", "rx_symbols"):
        assert_close_to_power(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)), 1e-5)


@pytest.mark.parametrize("modulation", [16, 64])
def test_simulate_qam_batch_higher_orders_match_jax(modulation):
    from ce5g_tpu.eval.ber import simulate_qam_frame
    from ce5g_torch.eval.ber import simulate_qam_batch

    jcfg = _simo_cfg()
    keys = jax.random.split(jax.random.key(modulation), 2)
    params = jax_params([0, 2], [10.0, 200.0], [20.0, 5.0], [0.1, 0.02])
    sim = functools.partial(simulate_qam_frame, cfg=jcfg, modulation=modulation)
    jf, jbits = jax.jit(jax.vmap(sim))(keys, params)
    tf, tbits = simulate_qam_batch(jax_qam_draws(keys, jcfg, modulation), _port_params(params),
                                   cfg=port_cfg(jcfg), modulation=modulation, device="cpu")
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(tf.tx_symbols.numpy(), np.asarray(jf.tx_symbols))
    assert_close_to_power(tf.rx_symbols.numpy(), np.asarray(jf.rx_symbols), 1e-5)


@pytest.mark.parametrize("estimator", ["ls", "mmse_full"])
def test_ber_counts_match_jax(qam_frames, estimator):
    """Per-frame bit errors within BIT_TOL of the bits counted; the
    counted bits equal exactly."""
    from ce5g_tpu.eval.ber import ber_frame as j_ber_frame
    from ce5g_torch.eval.ber import ber_batch

    jcfg, keys, params, _, (tf, tbits) = qam_frames
    j_ber = np.asarray(jax.jit(jax.vmap(functools.partial(
        j_ber_frame, cfg=jcfg, estimator=estimator)))(keys, params))
    errors, counted = ber_batch(tf, tbits, cfg=port_cfg(jcfg), estimator=estimator,
                                device="cpu")
    n_data = 2 * int((1 - tf.pilot_mask[0]).sum()) * 2  # rx chains × data REs × 2 bits
    np.testing.assert_array_equal(counted.numpy(), n_data)
    diff = np.abs(errors.numpy() - j_ber * n_data)
    assert np.all(diff <= BIT_TOL * n_data), diff
    assert np.all(np.diff(j_ber) < 0)  # BER falls with SNR (0 → 15 dB)


def test_ber_frame_is_batch_of_one(qam_frames):
    from ce5g_torch.eval.ber import QAMDraws, ber_batch, ber_frame, simulate_qam_frame
    from ce5g_torch.physics import FrameDraws

    jcfg, keys, params, _, (tf, tbits) = qam_frames
    cfg = port_cfg(jcfg)
    draws = jax_qam_draws(keys, jcfg)
    one = QAMDraws(FrameDraws(*(x[1] for x in draws.frame)), draws.bits[1])
    p1 = FrameParams(*(x[1] for x in _port_params(params)))
    frame, bits = simulate_qam_frame(one, p1, cfg=cfg, device="cpu")
    np.testing.assert_array_equal(bits.numpy(), tbits[1].numpy())
    np.testing.assert_array_equal(frame.rx_symbols.numpy(), tf.rx_symbols[1].numpy())
    errors, counted = ber_batch(tf, tbits, cfg=cfg, estimator="ls", device="cpu")
    assert float(ber_frame(one, p1, cfg=cfg, estimator="ls", device="cpu")) == pytest.approx(
        float(errors[1] / counted[1]), rel=1e-6)


def test_ber_sweep_runs_and_counts():
    from ce5g_torch.eval.ber import ber_sweep

    cfg = port_cfg(_simo_cfg())
    out = ber_sweep(cfg, [0.0, 20.0], estimator="ls", density=0.05, frames_per_point=2,
                    counts=True, device="cpu")
    assert list(out) == ["0.0", "20.0"]
    for point in out.values():
        assert point["bits"] > 0 and len(point["per_frame"]) == 2
        assert point["ber"] == pytest.approx(np.mean(point["per_frame"]))
    assert out["20.0"]["ber"] < out["0.0"]["ber"] < 0.5
    plain = ber_sweep(cfg, [0.0], estimator="ls", density=0.05, frames_per_point=2,
                      device="cpu")
    assert plain == {"0.0": out["0.0"]["ber"]}  # a point is a function of its seed


def test_metrics_helpers_match_jax():
    from ce5g_tpu.utils import metrics as jm
    from ce5g_torch.utils import awgn_noise, calculate_ber, evaluate_estimator

    rng = np.random.default_rng(0)
    h = (rng.standard_normal((3, 14, 2, 599)) + 1j * rng.standard_normal((3, 14, 2, 599)))
    h = h.astype(np.complex64)
    e = (h + 0.1 * rng.standard_normal(h.shape)).astype(np.complex64)
    got = evaluate_estimator(torch.from_numpy(h), torch.from_numpy(e))
    want = jm.evaluate_estimator(jnp.asarray(h), jnp.asarray(e))
    assert set(got) == set(want) == {"mse", "nmse", "nmse_db"}
    for key in got:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5)
    tx = rng.integers(0, 2, 1000)
    rx = tx.copy()
    rx[::7] ^= 1
    assert float(calculate_ber(torch.from_numpy(tx), torch.from_numpy(rx))) == pytest.approx(
        float(jm.calculate_ber(tx, rx)))

    gen = torch.Generator().manual_seed(1)
    n = awgn_noise(gen, (200, 1000), 10.0, signal_power=2.0, device="cpu")
    assert n.dtype == torch.complex64 and n.shape == (200, 1000)
    assert float((n.abs() ** 2).mean()) == pytest.approx(0.2, rel=0.02)  # 2 / 10^(10/10)
    assert abs(float(n.real.var() - n.imag.var())) < 0.005
    again = awgn_noise(torch.Generator().manual_seed(1), (200, 1000), 10.0, 2.0, device="cpu")
    assert torch.equal(n, again)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
@pytest.mark.parametrize("entry", ["draw_qam_frames", "simulate_qam_batch", "ber_sweep",
                                   "awgn_noise"])
def test_entry_points_default_to_the_card(entry):
    from ce5g_torch.eval import ber
    from ce5g_torch.physics.simulate import frame_params
    from ce5g_torch.utils import awgn_noise

    cfg = port_cfg(_simo_cfg())
    params = frame_params(1, 1, 50.0, 10.0, 0.05, "cpu")
    calls = {
        "draw_qam_frames": lambda: ber.draw_qam_frames(torch.Generator(), params, cfg),
        "simulate_qam_batch": lambda: ber.simulate_qam_batch(
            ber.draw_qam_frames(torch.Generator(), params, cfg, device="cpu"), params, cfg=cfg),
        "ber_sweep": lambda: ber.ber_sweep(cfg, [10.0], frames_per_point=1),
        "awgn_noise": lambda: awgn_noise(torch.Generator(), (4,), 10.0),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
