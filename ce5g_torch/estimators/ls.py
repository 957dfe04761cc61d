"""Least-squares channel estimation, batched.

Port of ``ce5g_tpu.estimators.ls`` (reference src/baseline_estimators.py:
10-117). Every call-site sends the same grid on all TX antennas, so the
estimate is of the superposition channel Σ_tx H·x: one estimate per rx
antenna, broadcast over tx.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.profiling import annotate
from .interpolate import interpolate, interpolate_grid

_EPS = 1e-12


def masked_ls_grid(rx_symbols, tx_grid, pilot_mask):
    """M·Y/(X + 1e-12) per rx antenna (reference :40): (B, R, S, K)."""
    m = pilot_mask.to(torch.float32)
    rx_grids = rx_symbols.transpose(1, 2).contiguous()  # (B, R, S, K)
    return m[:, None] * (rx_grids / (tx_grid + _EPS)[:, None])


def ls_at_pilots(rx_grid, tx_grid, positions, valid):
    """LS estimates at the pilot slots, H_p = Y_p/(X_p + 1e-12)
    (reference :40), invalid slots zeroed.

    Args:
        rx_grid: (B, R, S, K) complex received grid per rx antenna.
        tx_grid: (B, S, K) complex transmitted grid.
        positions: (B, P, 2) int32; valid: (B, P) float32.

    Returns:
        (B, R, P) complex.
    """
    b, r, s, k = rx_grid.shape
    lin = (positions[..., 0].long() * k + positions[..., 1].long())  # (B, P)
    y_p = rx_grid.reshape(b, r, s * k).gather(-1, lin[:, None].expand(b, r, -1))
    x_p = tx_grid.reshape(b, s * k).gather(-1, lin)
    return y_p / (x_p + _EPS)[:, None] * valid.to(torch.float32)[:, None]


def ls_estimate(rx_symbols, tx_grid, positions, valid, grid_shape: Tuple[int, int],
                num_tx: int, method: str = "linear", pilot_mask=None):
    """Full LS estimation with interpolation (reference :83-117).

    Args:
        rx_symbols: (B, S, R, K) complex received symbols.
        tx_grid: (B, S, K) complex transmitted grid (common to all antennas).
        positions: (B, P, 2) int32 pilot slots; valid: (B, P) float32.
        grid_shape: (S, K).
        num_tx: broadcast factor for the tx axis of the output.
        pilot_mask: optional (B, S, K) mask. With it, and 'nearest' or
            'linear', the estimate runs in grid form (the masked LS grid
            into ``interpolate_grid``); otherwise in slot form (the LS
            values at the pilot slots into ``interpolate``). Same estimate
            either way.

    Returns:
        (B, S, R, T, K) complex64 — identical along T (reference behaviour).

    Spans (``utils.profiling``): ``ls.pilots`` (the LS values), then
    ``ls.interpolate``.
    """
    if pilot_mask is not None and method in ("nearest", "linear"):
        with annotate("ls.pilots"):
            g = masked_ls_grid(rx_symbols, tx_grid, pilot_mask)
        with annotate("ls.interpolate"):
            h_full = interpolate_grid(g, pilot_mask, method)
    else:
        with annotate("ls.pilots"):
            h_p = ls_at_pilots(rx_symbols.transpose(1, 2), tx_grid, positions, valid)
        with annotate("ls.interpolate"):
            h_full = interpolate(h_p, positions, valid, grid_shape, method)
    h_full = h_full.transpose(1, 2)  # (B, S, R, K)
    b, s, r, k = h_full.shape
    return h_full[:, :, :, None, :].expand(b, s, r, num_tx, k)
