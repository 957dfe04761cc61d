"""Least-squares channel estimation, batched, grid form.

Port of the grid branch of ``ce5g_tpu.estimators.ls.ls_estimate``
(:74-80; reference src/baseline_estimators.py:83-117). Every call-site
sends the same grid on all TX antennas, so the estimate is of the
superposition channel Σ_tx H·x: one estimate per rx antenna, broadcast
over tx.
"""
from __future__ import annotations

import torch

from .interpolate import interpolate_grid

_EPS = 1e-12


def masked_ls_grid(rx_symbols, tx_grid, pilot_mask):
    """M·Y/(X + 1e-12) per rx antenna (reference :40): (B, R, S, K)."""
    m = pilot_mask.to(torch.float32)
    rx_grids = rx_symbols.transpose(1, 2).contiguous()  # (B, R, S, K)
    return m[:, None] * (rx_grids / (tx_grid + _EPS)[:, None])


def ls_estimate(rx_symbols, tx_grid, pilot_mask, num_tx: int, method: str = "linear"):
    """Full LS estimation with interpolation.

    Args:
        rx_symbols: (B, S, R, K) complex received symbols.
        tx_grid: (B, S, K) complex transmitted grid (common to all antennas).
        pilot_mask: (B, S, K) pilot mask.
        num_tx: broadcast factor for the tx axis of the output.

    Returns:
        (B, S, R, T, K) complex64 — identical along T (reference behaviour).
    """
    g = masked_ls_grid(rx_symbols, tx_grid, pilot_mask)
    h_full = interpolate_grid(g, pilot_mask, method).transpose(1, 2)  # (B, S, R, K)
    b, s, r, k = h_full.shape
    return h_full[:, :, :, None, :].expand(b, s, r, num_tx, k)
