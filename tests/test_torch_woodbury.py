"""The port's float32 mmse_full at high SNR, against its own float64 run.

The JAX package finishes the Woodbury solve as x = (e − √T·D·(V⊗√w)z)/σ²
on the pilots and Ĥ = R_t·x·w·F (ce5g_tpu/estimators/mmse.py:405-419): at
high SNR x is the difference of two nearly equal vectors over a small σ²,
so float32 rounding in e is multiplied by about 1/σ². The port solves the
same filter by the push-through identity, Ĥ = (V⊗√w)z·F/√T, which has no
such difference, from a Woodbury system assembled in float64 and a float32
solve refined once. Here float32 mmse_full (both branches) and the blind
mmse_full_est are held to the float64 run of the same path within 1e-4 of
each frame's rms at 20-30 dB, on 1×2 and 2×2 frames; and the direct form in
float64 is held to the Woodbury form in float64 within 1e-9 of the rms.
"""
import numpy as np
import pytest
import torch

from ce5g_torch import ExperimentConfig, MIMOConfig, OFDMConfig
from ce5g_torch.estimators import estimate_batch
from ce5g_torch.estimators.time_prior import auto_time_rank
from ce5g_torch.estimators.blind import device_tables_for, estimate_priors
from ce5g_torch.estimators.mmse import mmse_full_estimate
from ce5g_torch.physics import FrameParams, draw_frames, simulate_batch
from ce5g_torch.physics.simulate import table_for, table_tensors

from _torch_parity import woodbury_mmse_full

CPU = torch.device("cpu")
MIMO = ((1, 2), (2, 2))
SNRS = (20.0, 25.0, 30.0)


def _cfg(num_tx, num_rx):
    return ExperimentConfig(
        ofdm=OFDMConfig(fft_size=64, cp_length=8, num_symbols=6, useful_subcarriers=40),
        mimo=MIMOConfig(num_tx=num_tx, num_rx=num_rx),
    )


def _frames(cfg, snr_db, seed=11):
    """Six frames of every profile at 10-200 Hz, 5-15% pilots, one SNR."""
    params = FrameParams(
        torch.tensor([0, 1, 2, 2, 1, 0], dtype=torch.int32),
        torch.tensor([10.0, 50.0, 100.0, 200.0, 200.0, 50.0]),
        torch.full((6,), snr_db),
        torch.tensor([0.05, 0.10, 0.15, 0.10, 0.05, 0.10]),
    )
    draws = draw_frames(torch.Generator().manual_seed(seed), params, cfg, device=CPU)
    return simulate_batch(draws, params, cfg=cfg, device=CPU)


def _args(cfg, frames, dtype):
    """mmse_full_estimate's arguments for ``frames`` with the true priors,
    widened to complex128 / float64 where ``dtype`` is."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    amp, f = table_tensors(table_for(cfg), cfg, CPU)
    pidx = frames.params.profile_idx.long()
    return (frames.rx_symbols.to(dtype), frames.tx_symbols[:, :, 0, :].to(dtype),
            frames.pilot_mask, cfg.mimo.num_tx, frames.params.snr_db, f[pidx].to(dtype),
            amp[pidx].to(real), frames.params.doppler_hz, cfg.ofdm.symbol_duration)


def _blind_args(cfg, frames, dtype):
    """mmse_full_estimate's arguments with the blind priors, as
    estimate_batch(estimator='mmse_full_est') builds them."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    tables = device_tables_for(cfg, table_for(cfg), CPU)
    tx = frames.tx_symbols[:, :, 0, :]
    pri = estimate_priors(frames.rx_symbols, tx, frames.pilot_mask, tables, cfg.mimo.num_tx)
    p_ch = pri.w_tap.sum(-1)
    snr_db = 10.0 * torch.log10((cfg.mimo.num_tx * p_ch / pri.sigma2).clamp(min=1e-12))
    f = tables.f_dict.expand(len(snr_db), *tables.f_dict.shape)
    return (frames.rx_symbols.to(dtype), tx.to(dtype), frames.pilot_mask, cfg.mimo.num_tx,
            snr_db, f.to(dtype), torch.sqrt(2.0 * pri.w_tap).to(real), pri.doppler_hz,
            cfg.ofdm.symbol_duration)


def _err_over_rms(got, ref):
    """max |got − ref| over each frame's rms of ``ref``, frame by frame."""
    ref = ref.flatten(1)
    err = (got.to(ref.dtype).flatten(1) - ref).abs().max(1).values
    return (err / (ref.abs() ** 2).mean(1).sqrt()).numpy()


@pytest.mark.parametrize("snr_db", SNRS)
@pytest.mark.parametrize("mimo", MIMO, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("path", ["mmse_full", "mmse_full:per_frame", "mmse_full_est"])
def test_float32_matches_float64(path, mimo, snr_db):
    cfg = _cfg(*mimo)
    frames = _frames(cfg, snr_db)
    rank = auto_time_rank(cfg)
    if path == "mmse_full_est":
        ref = mmse_full_estimate(*_blind_args(cfg, frames, torch.complex128), time_rank=rank)
        got = estimate_batch(frames, cfg=cfg, estimator="mmse_full_est", device=CPU)
    else:
        ref = mmse_full_estimate(*_args(cfg, frames, torch.complex128), time_rank=rank)
        if path == "mmse_full":  # the profile tables' branch
            got = estimate_batch(frames, cfg=cfg, estimator="mmse_full", device=CPU)
        else:
            got = mmse_full_estimate(*_args(cfg, frames, torch.complex64), time_rank=rank)
    assert got.dtype == torch.complex64 and ref.dtype == torch.complex128
    err = _err_over_rms(got, ref)
    assert np.all(err <= 1e-4), err


@pytest.mark.parametrize("time_rank", ["auto", None])
@pytest.mark.parametrize("snr_db", (10.0, 30.0))
@pytest.mark.parametrize("mimo", MIMO, ids=lambda m: f"{m[0]}x{m[1]}")
def test_direct_form_is_the_woodbury_form(mimo, snr_db, time_rank):
    """In float64 the push-through form equals the JAX package's Woodbury
    form (tests/_torch_parity.py::woodbury_mmse_full) on the same inputs."""
    cfg = _cfg(*mimo)
    frames = _frames(cfg, snr_db, seed=12)
    rank = auto_time_rank(cfg) if time_rank == "auto" else None
    args = _args(cfg, frames, torch.complex128)
    got = mmse_full_estimate(*args, time_rank=rank)
    ref = woodbury_mmse_full(*args, time_rank=rank)
    err = _err_over_rms(got, ref)
    assert np.all(err <= 1e-9), err
