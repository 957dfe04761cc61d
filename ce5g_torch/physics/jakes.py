"""Jakes sum-of-sinusoids Rayleigh fading, batched.

Port of ``ce5g_tpu.physics.jakes`` (reference src/channel_simulator.py:84-127):
per path and (rx, tx) pair, O oscillators with random arrival angles and
phases,

    h(t) = (Σ_n cos(2π·fd·cos(a_n)·t + φ_n) + j Σ_n sin(...)) / sqrt(2·O),

evaluated only at the requested times. The 1/sqrt(2·O) scale is the
reference's: it gives E|h|² = ½ per path, not unit power. The angles and
phases (radians, i.e. 2π·U(0,1) draws) are passed in; they are drawn only
by :func:`jakes_oscillator_params`, from a ``torch.Generator``.

The time-domain chain needs the gains at every sample (:func:`dense_fading`),
evaluated in blocks of time and of frames so that the (frames, block,
P·R·T·O) trigonometric intermediate stays within a fixed size.
"""
from __future__ import annotations

import math

import torch

#: most elements of one (frames, block, P·R·T·O) intermediate of dense_fading
_DENSE_ELEMENTS = 1 << 26


def jakes_oscillator_params(generator: torch.Generator, num_paths: int, num_rx: int,
                            num_tx: int, num_osc: int, device="cuda", batch=()):
    """Angles and phases ~ U(0, 2π), each of shape (*batch, P, R, T, O),
    the angles drawn first (``ce5g_tpu`` jakes.py:40-47). The generator
    must live on ``device``."""
    shape = (*batch, num_paths, num_rx, num_tx, num_osc)
    two_pi = 2.0 * math.pi

    def uniform():
        return two_pi * torch.rand(shape, generator=generator, device=device,
                                   dtype=torch.float32)

    angles = uniform()
    return angles, uniform()


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


def dense_fading(angles, phases, doppler_hz, amp, num_samples: int, sampling_rate: float,
                 block: int = 2048):
    """Per-sample fading gains for the time-domain chain
    (``ce5g_tpu`` jakes.py:115-143).

    Args:
        angles, phases: (B, P, R, T, O) oscillator parameters in radians.
        doppler_hz: (B,); amp: (B, P) per-path amplitudes.
        num_samples: N, the frame's samples.

    Returns:
        complex64 (B, N, R, T, P). Sample n is evaluated at the float32 time
        (start + i) / sampling_rate with start = block·⌊n / block⌋, as the
        JAX package forms it, so both packages see the same Jakes phases.
    """
    b, p, r, t, o = angles.shape
    out = torch.empty((b, num_samples, r, t, p), dtype=torch.complex64, device=angles.device)
    fd = torch.as_tensor(doppler_hz, dtype=torch.float32, device=angles.device)
    frames = max(1, _DENSE_ELEMENTS // (block * p * r * t * o))
    for f0 in range(0, b, frames):
        f1 = min(b, f0 + frames)
        scale = amp[f0:f1, None, None, None, :].to(torch.complex64)
        for start in range(0, num_samples, block):
            n = min(block, num_samples - start)
            times = (start + torch.arange(n, dtype=torch.float32, device=angles.device)) / sampling_rate
            g = jakes_gains_at_times(angles[f0:f1], phases[f0:f1], fd[f0:f1], times)
            out[f0:f1, start:start + n] = g * scale
    return out
