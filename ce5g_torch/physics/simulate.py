"""Frame simulation, batched over frames: the frequency-domain main path
and the time-domain TX/RX chain.

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

:func:`simulate_batch_time_domain` is the time-domain chain of
``simulate_frame_time_domain`` (simulate.py:174-260): OFDM modulation,
per-sample Jakes fading through the time-varying FIR, AWGN at the frame's
measured power over all its samples, demodulation. Its draws are those of
the frequency-domain path except the noise, which is drawn per received
sample: ``draw_frames(..., time_domain=True)``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from ..config import ExperimentConfig
from ..device import resolve_device
from ..ops import channel as ops_channel
from ..utils.profiling import annotate
from .jakes import dense_fading, jakes_oscillator_params, path_gains_symbol_sampled
from .mimo import frequency_response, time_domain_apply
from .ofdm import demodulate, modulate
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
    # (B, S, R, K) N(0,1) — mimo.py:60-61; on the time-domain chain
    # (B, R, S·(fft+cp)) — simulate.py:233-241
    noise_re: torch.Tensor
    noise_im: torch.Tensor


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
    time_domain: bool = False,
) -> FrameDraws:
    """Draw one batch's random numbers with ``generator`` on ``device``;
    ``time_domain`` draws the noise per received sample, for
    :func:`simulate_batch_time_domain`.

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

    pilot_u = uniform(b, s * k)
    tx_phase = two_pi * uniform(b, s, t if orthogonal_pilots else 1, k)
    angles, phases = jakes_oscillator_params(generator, MAX_PATHS, r, t, o, dev, batch=(b,))
    noise = (b, r, s * cfg.ofdm.samples_per_symbol) if time_domain else (b, s, r, k)
    return FrameDraws(pilot_u, tx_phase, angles, phases, normal(*noise), normal(*noise))


def _prepare(draws: FrameDraws, params: FrameParams, cfg: ExperimentConfig,
             table: Optional[ProfileTable], orthogonal_pilots: bool, device):
    """The draws and params on the device, the table, the pilot pattern,
    the (B, S, T, K) transmit grid and each frame's profile index: what
    both chains start from."""
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
    return dev, draws, params, table, pattern, tx, params.profile_idx.long()


def _frame(tx, rx, h, pattern, params) -> Frame:
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
    Runs in the span ``physics.simulate``, its stages in ``physics.pattern``
    (the pilot pattern and the TX grid), ``physics.jakes`` and
    ``physics.channel`` (the channel H and the received grid, one
    ``ops.channel`` call: the TX grid's T extent picks its route;
    ``utils.profiling``).
    """
    with annotate("physics.simulate"):
        with annotate("physics.pattern"):
            dev, draws, params, table, pattern, tx, pidx = _prepare(
                draws, params, cfg, table, orthogonal_pilots, device)
        ofdm = cfg.ofdm
        amp_table, f_table = table_tensors(table, cfg, dev)
        amp = amp_table[pidx]  # (B, P)
        with annotate("physics.jakes"):
            gains = path_gains_symbol_sampled(
                draws.jakes_angles,
                draws.jakes_phases,
                params.doppler_hz,
                amp,
                ofdm.num_symbols,
                ofdm.samples_per_symbol,
                ofdm.sampling_rate,
            )  # (B, S, R, T, P)

        with annotate("physics.channel"):
            grid = tx if orthogonal_pilots else tx[:, :, :1]  # (B, S, T or 1, K)
            h, rx = ops_channel.channel(gains, f_table, pidx, grid, params.snr_db,
                                        draws.noise_re, draws.noise_im)
        return _frame(tx, rx, h, pattern, params)


def simulate_batch_time_domain(
    draws: FrameDraws,
    params: FrameParams,
    *,
    cfg: ExperimentConfig,
    table: Optional[ProfileTable] = None,
    orthogonal_pilots: bool = False,
    device="cuda",
) -> Frame:
    """Simulate a batch of frames through the full time-domain TX/RX chain
    (``ce5g_tpu`` simulate.py:174-260): grid → IFFT + CP → serialize →
    time-varying FIR (dense Jakes fading, per-tap delays) → AWGN at the
    frame's measured power → CP strip + FFT → grid.

    ``draws`` come from ``draw_frames(..., time_domain=True)``: the noise
    is (B, R, N) with N = S·(fft + cp). ``channel`` is the frequency
    response of the fading at each symbol's first sample, so NMSE compares
    with the frequency-domain path; the received grid also carries the
    fading's variation within a symbol and delays past the CP.
    """
    dev, draws, params, table, pattern, tx, pidx = _prepare(
        draws, params, cfg, table, orthogonal_pilots, device)
    ofdm, mimo = cfg.ofdm, cfg.mimo
    b, s = tx.shape[:2]
    sps = ofdm.samples_per_symbol
    n = s * sps
    if tuple(draws.noise_re.shape) != (b, mimo.num_rx, n):
        raise ValueError(f"time-domain noise of shape {tuple(draws.noise_re.shape)}, expected "
                         f"{(b, mimo.num_rx, n)}: draw_frames(..., time_domain=True)")

    tx_serial = modulate(tx.transpose(1, 2), ofdm).reshape(b, mimo.num_tx, n)  # (B, T, N)
    amp_table, f_table = table_tensors(table, cfg, dev)
    delays, valid = cached(
        table, ("td", str(dev)),
        lambda: (torch.as_tensor(table.delay_samples, device=dev),
                 torch.as_tensor(table.path_valid, device=dev)),
    )
    dense = dense_fading(draws.jakes_angles, draws.jakes_phases, params.doppler_hz,
                         amp_table[pidx], n, ofdm.sampling_rate)  # (B, N, R, T, P)
    y = time_domain_apply(tx_serial, dense, delays[pidx], valid[pidx])  # (B, R, N)

    # AWGN at the measured received power of the whole frame
    signal_power = (y.abs() ** 2).mean(dim=(1, 2))
    snr_linear = 10.0 ** (params.snr_db.float() / 10.0)
    noise_std = torch.sqrt(signal_power / snr_linear / 2.0)
    y = y + torch.complex(draws.noise_re, draws.noise_im) * noise_std[:, None, None]

    rx = demodulate(y.reshape(b, mimo.num_rx, s, sps), ofdm).transpose(1, 2)  # (B, S, R, K)
    h = frequency_response(dense[:, ::sps][:, :s], f_table[pidx])  # (B, S, R, T, K)
    return _frame(tx, rx.contiguous(), h, pattern, params)


def _one_frame(simulate, draws, params, **kwargs) -> Frame:
    one = lambda x: torch.as_tensor(x)[None]
    frames = simulate(FrameDraws(*map(one, draws)), FrameParams(*map(one, params)), **kwargs)
    return Frame(*(x[0] for x in frames[:-1]), FrameParams(*(x[0] for x in frames.params)))


def simulate_frame(draws: FrameDraws, params: FrameParams, **kwargs) -> Frame:
    """One frame of :func:`simulate_batch`: ``draws`` and ``params``
    without the batch axis."""
    return _one_frame(simulate_batch, draws, params, **kwargs)


def simulate_frame_time_domain(draws: FrameDraws, params: FrameParams, **kwargs) -> Frame:
    """One frame of :func:`simulate_batch_time_domain`: ``draws`` and
    ``params`` without the batch axis."""
    return _one_frame(simulate_batch_time_domain, draws, params, **kwargs)
