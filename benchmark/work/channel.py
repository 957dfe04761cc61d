"""Work of one batch's channel and received grid, counted from the shapes and
each frame's profile paths, never from the route that runs it: H (B, S, R,
T, K) complex64 written once, the two float32 noise planes read once, rx
(B, S, R, K) complex64 written once and the TX grid's (B, S, K) values read
once; the operations of ``work/step.py``'s channel and received-grid lines
(8·P a channel coefficient; 2·(T − 1)·P a (symbol, RX) for the TX sum of
the gains, then 8·P + 14 a received value)."""
from __future__ import annotations

from typing import Sequence, Tuple


def work(s: int, r: int, t: int, k: int, paths: Sequence[int]) -> Tuple[float, float]:
    """(bytes, float32 operations) of a batch whose frames have ``paths``
    profile paths each."""
    b = len(paths)
    srk = s * r * k
    nbytes = 8 * b * srk * t + 16 * b * srk + 8 * b * s * k
    flops = sum(8 * p * srk * t + 2 * (t - 1) * p * s * r + (8 * p + 14) * srk for p in paths)
    return float(nbytes), float(flops)
