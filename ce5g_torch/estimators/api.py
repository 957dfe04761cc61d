"""Frame-level estimation API: from simulated frames to Ĥ.

Port of ``ce5g_tpu.estimators.api``. The JAX package vmaps
``estimate_frame`` over frames; here ``estimate_batch`` is the batched
function and ``estimate_frame`` runs it on a batch of one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..device import resolve_device
from ..physics.profiles import ProfileTable, cached
from ..physics.simulate import Frame, FrameParams, table_for, table_tensors
from .blind import device_tables_for, estimate_priors
from .ls import ls_estimate
from .mmse import build_f_tables, mmse_diag_estimate, mmse_full_estimate


def _bessel_j0_np(x):
    """NumPy J0 (A&S 9.4.1/9.4.3, |err| < 1e-7) for host-side rank sizing."""
    x = np.abs(np.asarray(x, np.float64))
    t = (x / 3.0) ** 2
    small = 1.0 + t * (-2.2499997 + t * (1.2656208 + t * (-0.3163866
        + t * (0.0444479 + t * (-0.0039444 + t * 0.0002100)))))
    xs = np.maximum(x, 3.0)
    u = 3.0 / xs
    f0 = (0.79788456 + u * (-0.00000077 + u * (-0.00552740 + u * (-0.00009512
        + u * (0.00137237 + u * (-0.00072805 + u * 0.00014476))))))
    th0 = (xs - 0.78539816 + u * (-0.04166397 + u * (-0.00003954
        + u * (0.00262573 + u * (-0.00054125 + u * (-0.00029333
        + u * 0.00013558))))))
    large = f0 * np.cos(th0) / np.sqrt(xs)
    return np.where(x <= 3.0, small, large)


def auto_time_rank(cfg: ExperimentConfig) -> Optional[int]:
    """Legendre-projection rank of the mmse_full time prior: the smallest
    m whose projection reconstructs the worst-case (largest configured
    Doppler) R_t within 1e-5 relative Frobenius error — m = 5 for
    fd ≤ 200 Hz and m = 8 for fd ≤ 500 Hz at the default numerology.
    None (full rank) when no m < S reaches the tolerance."""
    s = cfg.ofdm.num_symbols
    fd_max = max(cfg.channel.doppler_hz)
    ds = np.arange(s, dtype=np.float64)
    tau = 2.0 * np.pi * fd_max * (ds[:, None] - ds[None, :]) * cfg.ofdm.symbol_duration
    rt = _bessel_j0_np(tau)
    x = np.linspace(-1.0, 1.0, s)
    norm = np.linalg.norm(rt)
    for m in range(2, s):
        q, _ = np.linalg.qr(np.polynomial.legendre.legvander(x, m - 1))
        rec = q @ (q.T @ rt @ q) @ q.T
        if np.linalg.norm(rec - rt) <= 1e-5 * norm:
            return m
    return None


def _to_device(frames: Frame, dev: torch.device) -> Frame:
    return Frame(
        *(x.to(dev) for x in frames[:-1]),
        FrameParams(*(x.to(dev) for x in frames.params)),
    )


def estimate_batch(
    frames: Frame,
    *,
    cfg: ExperimentConfig,
    estimator: str = "ls",
    method: str = "linear",
    table: Optional[ProfileTable] = None,
    time_rank: "int | None | str" = "auto",
    device="cuda",
) -> torch.Tensor:
    """Estimate the channel of a batch of simulated frames.

    Args:
        frames: batched :class:`Frame` (moved to ``device``).
        estimator: 'ls' | 'mmse' (reference-parity diagonal) | 'mmse_full'
            (per-subcarrier Wiener with correlation priors) |
            'mmse_full_est' (the same Wiener, with every prior — SNR,
            Doppler, delay profile — estimated from the frame's own pilots
            by :mod:`.blind`; ``frames.params`` is never read).
        method: interpolation for 'ls'/'mmse': 'nearest' or 'linear' (grid
            form, with the frames' pilot mask) or 'cubic' (slot form).
        time_rank: mmse_full time-prior rank — "auto" (sized from the max
            configured Doppler via :func:`auto_time_rank`), an int, or None
            for exact full rank.

    Returns:
        (B, S, R, T, K) complex64 channel estimate.
    """
    dev = resolve_device(device)
    frames = _to_device(frames, dev)
    if table is None:
        table = table_for(cfg)
    num_tx = cfg.mimo.num_tx
    grid_shape = (cfg.ofdm.num_symbols, cfg.ofdm.num_used_subcarriers)
    tx_grid = frames.tx_symbols[:, :, 0, :]  # common grid (reference parity)
    slots = (frames.pilot_positions, frames.pilot_valid, grid_shape, num_tx)

    if estimator == "ls":
        return ls_estimate(frames.rx_symbols, tx_grid, *slots, method,
                           pilot_mask=frames.pilot_mask)
    if estimator == "mmse":
        return mmse_diag_estimate(frames.rx_symbols, tx_grid, *slots, frames.params.snr_db,
                                  method, pilot_mask=frames.pilot_mask)
    rank = auto_time_rank(cfg) if time_rank == "auto" else time_rank
    if estimator == "mmse_full_est":
        # The deployable estimator: the delay prior is the union dictionary
        # with per-frame blended tap powers (never zeroing a candidate tap),
        # and σ̂² enters through the snr_db ↔ p_ch mapping, so mmse_full
        # reproduces the estimated noise variance exactly.
        tables = device_tables_for(cfg, table, dev)
        pri = estimate_priors(frames.rx_symbols, tx_grid, frames.pilot_mask, tables, num_tx)
        amp = torch.sqrt(2.0 * pri.w_tap)  # mmse_full folds w = ½·amp²
        p_ch = pri.w_tap.sum(-1)
        snr_db = 10.0 * torch.log10((num_tx * p_ch / pri.sigma2).clamp(min=1e-12))
        b = amp.shape[0]
        return mmse_full_estimate(
            frames.rx_symbols,
            tx_grid,
            frames.pilot_mask,
            num_tx,
            snr_db,
            tables.f_dict.expand(b, *tables.f_dict.shape),
            amp,
            pri.doppler_hz,
            cfg.ofdm.symbol_duration,
            time_rank=rank,
        )
    if estimator == "mmse_full":
        amp_t, f_t = table_tensors(table, cfg, dev)
        f_tables = cached(
            table, ("f_tables", str(dev)), lambda: build_f_tables(table.freq_response, dev)
        )
        pidx = frames.params.profile_idx.long()
        return mmse_full_estimate(
            frames.rx_symbols,
            tx_grid,
            frames.pilot_mask,
            num_tx,
            frames.params.snr_db,
            f_t[pidx],
            amp_t[pidx],
            frames.params.doppler_hz,
            cfg.ofdm.symbol_duration,
            time_rank=rank,
            f_tables=f_tables,
            profile_idx=pidx,
        )
    raise ValueError(f"Unknown estimator: {estimator!r}")


def estimate_frame(frame: Frame, **kwargs) -> torch.Tensor:
    """:func:`estimate_batch` on one unbatched frame: (S, R, T, K)."""
    one = Frame(
        *(torch.as_tensor(x)[None] for x in frame[:-1]),
        FrameParams(*(torch.as_tensor(x)[None] for x in frame.params)),
    )
    return estimate_batch(one, **kwargs)[0]
