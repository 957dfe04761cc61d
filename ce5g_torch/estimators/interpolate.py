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

:func:`normalized_conv_interpolate` (:329-375) is the normalised
convolution, separable Gaussian blurs by ``conv1d`` (no kernel of its
own: the JAX package blurs with ``lax.conv``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

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


def _gauss_kernel(sigma: float, device) -> torch.Tensor:
    r = int(max(2, 3 * sigma))
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur_axis(x: torch.Tensor, kern: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero-padded 'same' correlation of real ``x`` with ``kern`` along ``axis``."""
    moved = x.movedim(axis, -1)
    flat = moved.reshape(-1, 1, moved.shape[-1])
    out = F.conv1d(flat, kern.view(1, 1, -1), padding=(kern.shape[0] - 1) // 2)
    return out.reshape(moved.shape).movedim(-1, axis)


def normalized_conv_interpolate(pilot_grid: torch.Tensor, mask: torch.Tensor,
                                sigmas: Tuple[float, ...] = (1.5, 4.0, 12.0)):
    """Normalised-convolution (Shepard) interpolation
    (``ce5g_tpu.estimators.interpolate.normalized_conv_interpolate``):
    separable Gaussian blurs of value·mask and of the mask, coarse to fine,
    so sparse regions fall back to wider kernels. No reference analog.

    Args:
        pilot_grid: (..., S, K) complex grid with values only at pilot REs.
        mask: (S, K) or (..., S, K) float pilot mask.

    Returns:
        complex grid of ``pilot_grid``'s shape; zero where no kernel
        reaches a pilot.
    """
    def blur(x, kern):
        return _blur_axis(_blur_axis(x, kern, -1), kern, -2)

    den = torch.broadcast_to(mask, pilot_grid.shape).to(torch.float32)
    out = torch.zeros_like(pilot_grid)
    have = torch.zeros(pilot_grid.shape, dtype=torch.bool, device=pilot_grid.device)
    for sigma in sigmas:
        kern = _gauss_kernel(sigma, pilot_grid.device)
        d = blur(den, kern)
        est = torch.complex(blur(pilot_grid.real, kern), blur(pilot_grid.imag, kern))
        est = est / torch.clamp(d, min=1e-8)
        ok = d > 1e-3
        out = torch.where(~have & ok, est, out)
        have = have | ok
    return out
