"""Work of one grid-form interpolation, a frozen copy of the port's
``ops.interp_fused.work``: mask (B, S, K) float32 and values (B, R, S, K)
complex64 read once, the output written once; ≈ 5 operations a candidate
distance (S_out·C·K a frame, C = sides·S row candidates) and 4·R a
selected candidate (the weighted re/im accumulation), the selected ones
counted from this mask."""
from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.estimators import grid_weights


def work(mask: torch.Tensor, r: int, method: str) -> Tuple[float, float]:
    """(bytes, float32 operations) of the interpolation of ``mask``'s frames."""
    b, s, k = mask.shape
    w, pos = grid_weights(mask, method, torch.float32)
    sides = pos.shape[2]
    nbytes = 4 * b * s * k + 2 * 8 * b * r * s * k
    flops = 5 * b * s * (sides * s) * k + 4 * r * int((w > 0).sum())
    return nbytes, flops
