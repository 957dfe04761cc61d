"""Scattered pilot → full-grid interpolation, grid form.

Port of ``ce5g_tpu.estimators.interpolate.interpolate_grid`` (:224-326),
the form the main path takes whenever a pilot mask is given: the masked
VALUE GRID ((…, S, K), zeros off-pilot) and the mask go in, the full grid
comes out. 'nearest' is the nearest pilot by Euclidean distance over
(symbol, subcarrier); 'linear' is the k=3 tied-shell inverse-distance
weighting (statistical parity with the reference's ``griddata``,
src/baseline_estimators.py:44-81).

On CUDA tensors the work runs in the fused kernel
(``ops.interp_fused``); on CPU tensors in its plain PyTorch version.
"""
from __future__ import annotations

import torch

from ..ops.interp_fused import interpolate_grid_fused

_LATER = (
    "is not ported yet: the slot-form interpolation (cubic, or no pilot mask) "
    "comes with a later slice of the port"
)


def interpolate_grid(value_grid: torch.Tensor, mask: torch.Tensor, method: str = "linear"):
    """Grid-form scattered interpolation.

    Args:
        value_grid: (B, R, S, K) complex masked values, or (R, S, K) for one
            frame.
        mask: (B, S, K) pilot mask, or (S, K) for one frame.
        method: 'nearest' | 'linear'.

    Returns:
        complex64 grid of ``value_grid``'s shape.
    """
    if method == "cubic":
        raise NotImplementedError(f"method='cubic' {_LATER}")
    if mask is None:
        raise NotImplementedError(f"interpolation without a pilot mask {_LATER}")
    if method not in ("nearest", "linear"):
        raise ValueError(f"interpolate_grid supports nearest/linear, got {method!r}")
    if mask.ndim == 2:
        return interpolate_grid_fused(value_grid[None], mask[None], method)[0]
    return interpolate_grid_fused(value_grid, mask, method)
