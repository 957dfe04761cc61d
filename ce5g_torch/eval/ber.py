"""Measured end-to-end BER: QAM data over the simulated channel → channel
estimation → per-RE equalisation → minimum-distance demodulation → bit
compare. Port of ``ce5g_tpu.eval.ber`` (the reference only has the
analytic proxy, run_phase5_evaluation.py:57-68).

The reference sends the same grid on every TX antenna, so the channel a
receiver can estimate is the superposition Σ_t H; equalisation is the
per-(rx, RE) scalar Wiener x̂ = ĥ*·y / (|ĥ|² + σ²), and the BER is over
every rx chain.

Batched as the rest of the port: :func:`draw_qam_frames` draws a batch's
random numbers with a ``torch.Generator``, :func:`simulate_qam_batch`
builds the frames and :func:`ber_batch` scores them. A QAM frame has its
own draws, as in the JAX package, where the key splits five ways (pilot,
tx, fade, noise, bits; ber.py:50): the pilot phase is drawn on the whole
(S, K) grid, the payload bits are Bernoulli(½), and the channel is applied
with the full H (``physics.mimo.apply_channel``), not the common-grid
form. So QAM frames differ from ``simulate_batch``'s on the same draws.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..config import ExperimentConfig
from ..device import resolve_device
from ..estimators.api import estimate_batch
from ..physics.jakes import path_gains_symbol_sampled
from ..physics.mimo import apply_channel, frequency_response
from ..physics.pilots import insert_pilots, make_pattern
from ..physics.profiles import ProfileTable
from ..physics.simulate import (
    Frame,
    FrameDraws,
    FrameParams,
    draw_frames,
    frame_params,
    table_for,
    table_tensors,
)
from ..utils.qam import bits_per_symbol, qam_demodulate, qam_modulate


class QAMDraws(NamedTuple):
    """Every random number a batch of QAM frames needs. ``frame`` is laid
    out as for ``simulate_batch``; its ``tx_phase`` (B, S, 1, K) is the
    pilot phase (ber.py:61-63)."""

    frame: FrameDraws
    bits: torch.Tensor  # (B, S·K·bps) int32 Bernoulli(½) — ber.py:58


def draw_qam_frames(generator: torch.Generator, params: FrameParams, cfg: ExperimentConfig,
                    modulation: int = 4, device="cuda") -> QAMDraws:
    """Draw one batch of QAM frames with ``generator`` (on ``device``)."""
    dev = resolve_device(device)
    b = params.profile_idx.shape[0]
    n_bits = cfg.ofdm.num_symbols * cfg.ofdm.num_used_subcarriers * bits_per_symbol(modulation)
    frame = draw_frames(generator, params, cfg, device=dev)
    bits = torch.rand((b, n_bits), generator=generator, device=dev) < 0.5
    return QAMDraws(frame, bits.to(torch.int32))


def simulate_qam_batch(
    draws: QAMDraws,
    params: FrameParams,
    *,
    cfg: ExperimentConfig,
    table: Optional[ProfileTable] = None,
    modulation: int = 4,
    device="cuda",
):
    """Frames with Gray-QAM data on the non-pilot REs and unit-modulus
    random-phase pilots (``simulate_qam_frame`` of the JAX package, :33-97,
    batched). Returns (Frame, bits): bits (B, S·K·bps) is each frame's
    payload, pilot positions included (``ber_batch`` masks them out)."""
    dev = resolve_device(device)
    fd = FrameDraws(*(x.to(dev) for x in draws.frame))
    bits = draws.bits.to(dev)
    params = FrameParams(*(torch.as_tensor(x).to(dev) for x in params))
    if table is None:
        table = table_for(cfg)
    ofdm, mimo = cfg.ofdm, cfg.mimo
    s, k = ofdm.num_symbols, ofdm.num_used_subcarriers
    b = params.profile_idx.shape[0]

    pattern = make_pattern(fd.pilot_u, s, k, params.pilot_density, cfg.pilots.pattern,
                           cfg.pilots.max_density)
    data = qam_modulate(bits, modulation).reshape(b, s, k)
    pilots = torch.exp(1j * fd.tx_phase[:, :, 0, :]).to(torch.complex64)
    grid = insert_pilots(pattern, data, pilots)
    tx = grid[:, :, None, :].expand(b, s, mimo.num_tx, k)

    amp_table, f_table = table_tensors(table, cfg, dev)
    pidx = params.profile_idx.long()
    gains = path_gains_symbol_sampled(fd.jakes_angles, fd.jakes_phases, params.doppler_hz,
                                      amp_table[pidx], s, ofdm.samples_per_symbol,
                                      ofdm.sampling_rate)
    h = frequency_response(gains, f_table[pidx])
    rx = apply_channel(tx, h, params.snr_db, fd.noise_re, fd.noise_im)
    frame = Frame(
        tx_symbols=tx.contiguous(),
        rx_symbols=rx,
        channel=h,
        pilot_mask=pattern.mask,
        pilot_positions=pattern.positions,
        pilot_valid=pattern.valid,
        num_pilots=pattern.num_pilots,
        params=params,
    )
    return frame, bits


def bit_errors(h_sum, rx, pilot_mask, snr_db, bits, modulation: int = 4):
    """Per-frame (bit errors, data bits counted) of the scalar Wiener
    equaliser on every rx chain.

    Args:
        h_sum: (B, S, R, K) superposition-channel estimate Σ_t Ĥ.
        rx: (B, S, R, K) received grid; σ² = mean |y|² over (S, R, K) /
            SNR, per frame (ber.py:113-114).
        pilot_mask: (B, S, K); pilot REs are not counted.
        snr_db: (B,).
        bits: (B, S·K·bps) transmitted payload.

    Returns:
        (errors, counted), float32 (B,) each; counted is at least 1.
    """
    b, _, r, _ = rx.shape
    snr_lin = 10.0 ** (snr_db.to(torch.float32) / 10.0)
    sigma2 = (rx.abs() ** 2).mean(dim=(1, 2, 3)) / snr_lin
    x_hat = h_sum.conj() * rx / (h_sum.abs() ** 2 + sigma2[:, None, None, None])
    rx_bits = qam_demodulate(x_hat.movedim(2, 1).reshape(b, r, -1), modulation)  # (B, R, N)
    bps = bits_per_symbol(modulation)
    bit_mask = torch.repeat_interleave((1.0 - pilot_mask).reshape(b, -1), bps, dim=-1)  # (B, N)
    errors = ((rx_bits != bits[:, None, :]) * bit_mask[:, None, :]).sum(dim=(1, 2))
    counted = torch.clamp(bit_mask.sum(dim=-1) * r, min=1.0)
    return errors.to(torch.float32), counted


def ber_batch(frames: Frame, bits, *, cfg: ExperimentConfig, table=None,
              estimator: str = "mmse_full", modulation: int = 4, device="cuda"):
    """Score a batch of QAM frames with ``estimator`` (``ber_frame`` of the
    JAX package, :100-131, batched): per-frame (bit errors, data bits
    counted) over every rx chain; a frame's BER is their ratio."""
    dev = resolve_device(device)
    h_est = estimate_batch(frames, cfg=cfg, estimator=estimator, table=table, device=dev)
    return bit_errors(h_est.sum(dim=3), frames.rx_symbols.to(dev), frames.pilot_mask.to(dev),
                      frames.params.snr_db.to(dev), bits.to(dev), modulation)


def _simulate_one(draws: QAMDraws, params: FrameParams, **kwargs):
    """:func:`simulate_qam_batch` on unbatched ``draws`` and ``params``, as a
    batch of one."""
    def one(x):
        return torch.as_tensor(x)[None]

    return simulate_qam_batch(QAMDraws(FrameDraws(*map(one, draws.frame)), one(draws.bits)),
                              FrameParams(*map(one, params)), **kwargs)


def simulate_qam_frame(draws: QAMDraws, params: FrameParams, *, cfg: ExperimentConfig,
                       table=None, modulation: int = 4, device="cuda"):
    """One QAM frame: ``draws`` and ``params`` without the batch axis.
    Returns (Frame, bits (S·K·bps,))."""
    frames, bits = _simulate_one(draws, params, cfg=cfg, table=table, modulation=modulation,
                                 device=device)
    frame = Frame(*(x[0] for x in frames[:-1]), FrameParams(*(x[0] for x in frames.params)))
    return frame, bits[0]


def ber_frame(draws: QAMDraws, params: FrameParams, *, cfg: ExperimentConfig, table=None,
              estimator: str = "mmse_full", modulation: int = 4, device="cuda"):
    """Measured BER of one frame (unbatched ``draws`` and ``params``)."""
    frames, bits = _simulate_one(draws, params, cfg=cfg, table=table, modulation=modulation,
                                 device=device)
    errors, counted = ber_batch(frames, bits, cfg=cfg, table=table, estimator=estimator,
                                modulation=modulation, device=device)
    return (errors / counted)[0]


def ber_sweep(
    cfg: ExperimentConfig,
    snrs_db,
    *,
    profile_idx: int = 1,
    doppler_hz: float = 50.0,
    density: float = 0.1,
    estimator: str = "mmse_full",
    modulation: int = 4,
    frames_per_point: int = 32,
    seed: int = 0,
    counts: bool = False,
    device="cuda",
) -> Dict:
    """Measured BER against SNR, one batch a point: {str(snr): mean
    per-frame BER}. Point i draws its frames with a generator seeded
    ``seed + i``, as the JAX package keys point i with ``key(seed + i)``.
    With ``counts`` each point is {"ber", "errors", "bits", "per_frame"}."""
    dev = resolve_device(device)
    table = table_for(cfg)
    out: Dict = {}
    for i, snr in enumerate(snrs_db):
        params = frame_params(frames_per_point, profile_idx, doppler_hz, float(snr), density, dev)
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        draws = draw_qam_frames(gen, params, cfg, modulation, dev)
        frames, bits = simulate_qam_batch(draws, params, cfg=cfg, table=table,
                                          modulation=modulation, device=dev)
        errors, counted = ber_batch(frames, bits, cfg=cfg, table=table, estimator=estimator,
                                    modulation=modulation, device=dev)
        per_frame = (errors / counted).cpu()
        ber = float(per_frame.mean())
        out[str(float(snr))] = ber if not counts else {
            "ber": ber, "errors": int(errors.sum()), "bits": int(counted.sum()),
            "per_frame": per_frame.tolist()}
    return out
