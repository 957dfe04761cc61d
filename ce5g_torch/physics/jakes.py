"""Jakes sum-of-sinusoids Rayleigh fading, batched.

Port of ``ce5g_tpu.physics.jakes`` (reference src/channel_simulator.py:84-127):
per path and (rx, tx) pair, O oscillators with random arrival angles and
phases,

    h(t) = (Σ_n cos(2π·fd·cos(a_n)·t + φ_n) + j Σ_n sin(...)) / sqrt(2·O),

evaluated only at the requested times. The 1/sqrt(2·O) scale is the
reference's: it gives E|h|² = ½ per path, not unit power. The angles and
phases are passed in (radians, i.e. 2π·U(0,1) draws), never drawn here.
"""
from __future__ import annotations

import math

import torch


def jakes_gains_at_times(angles, phases, doppler_hz, times):
    """Evaluate the Jakes fading process at arbitrary times.

    Args:
        angles, phases: (B, P, R, T, O) oscillator parameters in radians.
        doppler_hz: (B,) max Doppler frequency per frame.
        times: (S,) sample times in seconds.

    Returns:
        complex64 gains of shape (B, S, R, T, P).
    """
    b, p, r, t, o = angles.shape
    fd = torch.as_tensor(doppler_hz, dtype=torch.float32, device=angles.device)
    fd = fd.reshape(-1, 1, 1, 1, 1)
    omega = (2.0 * math.pi * fd) * torch.cos(angles)  # Doppler radians/s
    # arg[b, s, (p,r,t,o)] = ω·t_s + φ
    arg = times[None, :, None] * omega.reshape(b, 1, -1) + phases.reshape(b, 1, -1)
    scale = 1.0 / math.sqrt(2.0 * o)
    re = torch.cos(arg).reshape(b, -1, p, r, t, o).sum(dim=-1) * scale
    im = torch.sin(arg).reshape(b, -1, p, r, t, o).sum(dim=-1) * scale
    return torch.complex(re, im).permute(0, 1, 3, 4, 2)  # (B, S, R, T, P)


def path_gains_symbol_sampled(
    angles,
    phases,
    doppler_hz,
    amp,
    num_symbols: int,
    samples_per_symbol: int,
    sampling_rate: float,
):
    """Per-path complex gains at each OFDM symbol start
    (reference channel_simulator.py:300-302), scaled by the per-path
    amplitudes ``amp`` (B, P).

    Returns:
        complex64 (B, S, R, T, P).
    """
    t = torch.arange(num_symbols, dtype=torch.float32, device=angles.device) * (
        samples_per_symbol / sampling_rate
    )
    g = jakes_gains_at_times(angles, phases, doppler_hz, t)
    return g * amp[:, None, None, None, :].to(g.dtype)
