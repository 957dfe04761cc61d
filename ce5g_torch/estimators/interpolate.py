"""Scattered pilot → full-grid interpolation, slot form and grid form.

Port of ``ce5g_tpu.estimators.interpolate``. 'nearest' is the nearest
pilot by Euclidean distance over (symbol, subcarrier); 'linear' is the
k=3 tied-shell inverse-distance weighting (statistical parity with the
reference's ``griddata``, src/baseline_estimators.py:44-81); 'cubic' is a
Gaussian smoother whose bandwidth follows the nearest-pilot distance.

* :func:`interpolate` (slot form, :95-145) takes the values at the padded
  pilot slots with their positions; it serves every method. On CUDA
  tensors it runs the kernel of ``ops.interp``.
* :func:`interpolate_grid` (grid form, :224-326) takes the masked VALUE
  GRID ((…, S, K), zeros off-pilot) and the mask; 'nearest' and 'linear'
  only. On CUDA tensors it runs the kernel of ``ops.interp_fused``.

On CPU tensors both run their kernel's plain PyTorch version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.interp import interpolate_slots
from ..ops.interp_fused import interpolate_grid_fused


def interpolate(pilot_values: torch.Tensor, positions: torch.Tensor, valid: torch.Tensor,
                grid_shape: Tuple[int, int], method: str = "linear"):
    """Expand pilot-slot values to the full grid.

    Args:
        pilot_values: (B, R, P) complex values per (padded) pilot slot, or
            (R, P) for one frame.
        positions: (B, P, 2) int32 (symbol, subcarrier) of each slot, or
            (P, 2).
        valid: (B, P) float32 slot validity, or (P,).
        grid_shape: (S, K).
        method: 'nearest' | 'linear' | 'cubic'.

    Returns:
        (B, R, S, K) complex64, or (R, S, K) for one frame.
    """
    if positions.ndim == 2:
        return interpolate_slots(pilot_values[None], positions[None], valid[None],
                                 grid_shape, method)[0]
    return interpolate_slots(pilot_values, positions, valid, grid_shape, method)


def interpolate_grid(value_grid: torch.Tensor, mask: torch.Tensor, method: str = "linear"):
    """Grid-form scattered interpolation.

    Args:
        value_grid: (B, R, S, K) complex masked values, or (R, S, K) for one
            frame.
        mask: (B, S, K) pilot mask, or (S, K) for one frame.
        method: 'nearest' | 'linear' ('cubic' takes the slot form).

    Returns:
        complex64 grid of ``value_grid``'s shape.
    """
    if method not in ("nearest", "linear"):
        raise ValueError(f"interpolate_grid supports nearest/linear, got {method!r}")
    if mask is None:
        raise ValueError("interpolate_grid needs the pilot mask; the slot form "
                         "(interpolate) takes positions instead")
    if mask.ndim == 2:
        return interpolate_grid_fused(value_grid[None], mask[None], method)[0]
    return interpolate_grid_fused(value_grid, mask, method)
