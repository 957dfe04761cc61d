"""Frequency-domain frame simulation, batched over frames.

Port of ``ce5g_tpu.physics.simulate`` (reference
src/channel_simulator.py:348-421). The JAX package draws each frame's
randomness from one PRNG key inside ``simulate_frame``; torch cannot
reproduce those threefry draws, so here every random number arrives in a
:class:`FrameDraws` tensor tuple. :func:`draw_frames` makes the draws with
a ``torch.Generator``; a test can instead hand in the JAX package's own
draws and get the same frames.

Reference behaviour reproduced:
  * unit-modulus random-phase pilot and data symbols exp(j·U(0,2π));
  * the SAME grid on every TX antenna unless ``orthogonal_pilots``;
  * channel sampled at symbol starts, frequency response over the 599
    DC-removed bins, AWGN at each frame's measured power.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from ..config import ExperimentConfig
from ..device import resolve_device
from .jakes import path_gains_symbol_sampled
from .mimo import apply_channel, apply_channel_common_grid, frequency_response
from .pilots import make_pattern
from .profiles import MAX_PATHS, ProfileTable, build_profile_table, cached


class FrameParams(NamedTuple):
    """Per-frame simulation parameters, each of shape (B,)."""

    profile_idx: torch.Tensor  # int index into PROFILE_NAMES
    doppler_hz: torch.Tensor
    snr_db: torch.Tensor
    pilot_density: torch.Tensor


class Frame(NamedTuple):
    """Simulated frames (reference return dict, channel_simulator.py:412-421)."""

    tx_symbols: torch.Tensor  # (B, S, T, K) complex64
    rx_symbols: torch.Tensor  # (B, S, R, K) complex64
    channel: torch.Tensor  # (B, S, R, T, K) complex64 (H_true)
    pilot_mask: torch.Tensor  # (B, S, K) float32
    pilot_positions: torch.Tensor  # (B, P_max, 2) int32
    pilot_valid: torch.Tensor  # (B, P_max) float32
    num_pilots: torch.Tensor  # (B,) int32
    params: FrameParams


class FrameDraws(NamedTuple):
    """Every random number one batch of frames needs.

    In ``ce5g_tpu`` each frame key splits into (pilot, tx, fade, noise)
    keys (simulate.py:107); the fields map onto those draws.
    """

    pilot_u: torch.Tensor  # (B, S·K) U(0,1) — pilots.py:52
    tx_phase: torch.Tensor  # (B, S, 1, K) or (B, S, T, K) U(0,2π) — simulate.py:83-90
    jakes_angles: torch.Tensor  # (B, P, R, T, O) U(0,2π) — jakes.py:45
    jakes_phases: torch.Tensor  # (B, P, R, T, O) U(0,2π) — jakes.py:46
    noise_re: torch.Tensor  # (B, S, R, K) N(0,1) — mimo.py:60
    noise_im: torch.Tensor  # (B, S, R, K) N(0,1) — mimo.py:61


def frame_params(b: int, profile_idx: int, doppler_hz: float, snr_db: float, density: float,
                 device) -> FrameParams:
    """``b`` frames of one (profile, Doppler, SNR, density) cell on ``device``."""
    def full(v, dtype):
        return torch.full((b,), v, dtype=dtype, device=device)

    return FrameParams(full(profile_idx, torch.int32), full(doppler_hz, torch.float32),
                       full(snr_db, torch.float32), full(density, torch.float32))


@functools.lru_cache(maxsize=16)
def table_for(cfg: ExperimentConfig) -> ProfileTable:
    """The profile table for ``cfg``'s numerology (one per config)."""
    return build_profile_table(
        cfg.ofdm.sampling_rate, cfg.ofdm.fft_size, cfg.ofdm.useful_subcarriers
    )


def table_tensors(table: ProfileTable, cfg: ExperimentConfig, device: torch.device):
    """(amp (C, P) float32 for ``cfg``'s tap collision rule, freq_response
    (C, P, K) complex64) on ``device``, built once per table and device."""
    amp_np = (
        table.amp_overwrite
        if cfg.channel.tap_collision == "overwrite"
        else table.amp_accumulate
    )
    return cached(
        table,
        ("sim", cfg.channel.tap_collision, str(device)),
        lambda: (
            torch.as_tensor(amp_np, device=device),
            torch.as_tensor(table.freq_response, device=device),
        ),
    )


def draw_frames(
    generator: torch.Generator,
    params: FrameParams,
    cfg: ExperimentConfig,
    device="cuda",
    orthogonal_pilots: bool = False,
) -> FrameDraws:
    """Draw one batch's random numbers with ``generator`` on ``device``.

    The generator must live on ``device``. The law of every draw is that
    of ``ce5g_tpu``'s; the numbers themselves differ.
    """
    dev = resolve_device(device)
    b = params.profile_idx.shape[0]
    s = cfg.ofdm.num_symbols
    k = cfg.ofdm.num_used_subcarriers
    r, t = cfg.mimo.num_rx, cfg.mimo.num_tx
    o = cfg.channel.num_oscillators
    two_pi = 2.0 * math.pi

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev, dtype=torch.float32)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)

    return FrameDraws(
        pilot_u=uniform(b, s * k),
        tx_phase=two_pi * uniform(b, s, t if orthogonal_pilots else 1, k),
        jakes_angles=two_pi * uniform(b, MAX_PATHS, r, t, o),
        jakes_phases=two_pi * uniform(b, MAX_PATHS, r, t, o),
        noise_re=normal(b, s, r, k),
        noise_im=normal(b, s, r, k),
    )


def simulate_batch(
    draws: FrameDraws,
    params: FrameParams,
    *,
    cfg: ExperimentConfig,
    table: Optional[ProfileTable] = None,
    orthogonal_pilots: bool = False,
    device="cuda",
) -> Frame:
    """Simulate a batch of MIMO-OFDM frames in the frequency domain.

    ``draws`` and ``params`` are moved to ``device``; every output lies there.
    """
    dev = resolve_device(device)
    draws = FrameDraws(*(x.to(dev) for x in draws))
    params = FrameParams(*(torch.as_tensor(x).to(dev) for x in params))
    if table is None:
        table = table_for(cfg)
    ofdm, mimo = cfg.ofdm, cfg.mimo
    num_sc = ofdm.num_used_subcarriers
    b = params.profile_idx.shape[0]

    pattern = make_pattern(
        draws.pilot_u,
        ofdm.num_symbols,
        num_sc,
        params.pilot_density,
        cfg.pilots.pattern,
        cfg.pilots.max_density,
    )

    if draws.tx_phase.shape[2] != (mimo.num_tx if orthogonal_pilots else 1):
        raise ValueError(
            f"tx_phase of shape {tuple(draws.tx_phase.shape)} does not match "
            f"orthogonal_pilots={orthogonal_pilots} with {mimo.num_tx} TX antennas"
        )
    tx = torch.exp(1j * draws.tx_phase).to(torch.complex64)
    tx = tx.expand(b, ofdm.num_symbols, mimo.num_tx, num_sc)

    amp_table, f_table = table_tensors(table, cfg, dev)
    pidx = params.profile_idx.long()
    amp = amp_table[pidx]  # (B, P)
    gains = path_gains_symbol_sampled(
        draws.jakes_angles,
        draws.jakes_phases,
        params.doppler_hz,
        amp,
        ofdm.num_symbols,
        ofdm.samples_per_symbol,
        ofdm.sampling_rate,
    )  # (B, S, R, T, P)

    freq_matrix = f_table[pidx]  # (B, P, K)
    h = frequency_response(gains, freq_matrix)  # (B, S, R, T, K)

    if orthogonal_pilots:
        rx = apply_channel(tx, h, params.snr_db, draws.noise_re, draws.noise_im)
    else:
        # common grid on all TX ⇒ the TX sum moves onto the path gains
        rx = apply_channel_common_grid(
            tx[:, :, 0, :], gains, freq_matrix, params.snr_db,
            draws.noise_re, draws.noise_im,
        )

    return Frame(
        tx_symbols=tx.contiguous(),
        rx_symbols=rx,
        channel=h,
        pilot_mask=pattern.mask,
        pilot_positions=pattern.positions,
        pilot_valid=pattern.valid,
        num_pilots=pattern.num_pilots,
        params=params,
    )


def simulate_frame(
    draws: FrameDraws,
    params: FrameParams,
    *,
    cfg: ExperimentConfig,
    table: Optional[ProfileTable] = None,
    orthogonal_pilots: bool = False,
    device="cuda",
) -> Frame:
    """One frame: ``draws`` and ``params`` without the batch axis."""
    one = lambda x: torch.as_tensor(x)[None]
    frames = simulate_batch(
        FrameDraws(*map(one, draws)),
        FrameParams(*map(one, params)),
        cfg=cfg,
        table=table,
        orthogonal_pilots=orthogonal_pilots,
        device=device,
    )
    return Frame(*(x[0] for x in frames[:-1]), FrameParams(*(x[0] for x in frames.params)))
