"""Work of the batch's score, a frozen copy of the port's ``ops.nmse.work``
taking the shapes instead of tensors: the channel H (B, S, R, T, K)
complex64 read once and the estimate's distinct values (B, S, R, K), the
estimators' broadcast along TX left out, read once; 10 operations an
element of H (the difference, two |·|² and two sums). Counted from the
shapes, never from the route that runs it."""
from __future__ import annotations

from typing import Tuple


def work(b: int, s: int, r: int, t: int, k: int) -> Tuple[float, float]:
    """(bytes, float32 operations)."""
    nbytes = 8 * b * s * r * t * k + 8 * b * s * r * k
    return nbytes, 10 * b * s * r * t * k
