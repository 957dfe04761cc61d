"""Work of one batch's per-frame profile sums of ``mmse_full``: the E sums
(each frame's LS grid against its own profile's P paths) and the D sums
(its pilot mask against the P² path pairs), counted from the shapes, each
frame's profile paths and its pilots, never from how many profiles the
program contracts or which route runs it.

Bytes: the LS grid (B, R, S, K) complex64 and the mask (B, S, K) float32
read once; E (R, S, P) and D (S, P, P) complex128 written once a frame.
Operations, float64, ``work/step.py``'s pilot sums: 8·R·n·P for E and
8·n·P(P + 1)/2 for D (n the frame's pilots, D Hermitian)."""
from __future__ import annotations

from typing import Sequence, Tuple


def work(s: int, r: int, k: int, paths: Sequence[int],
         n_pilots: Sequence[int]) -> Tuple[float, float]:
    """(bytes, float64 operations) of a batch whose frames have ``paths``
    profile paths and ``n_pilots`` pilots each."""
    b = len(paths)
    nbytes = b * (8 * r * s * k + 4 * s * k)
    nbytes += sum(16 * r * s * p + 16 * s * p * p for p in paths)
    flops = sum(8 * r * n * p + 8 * n * p * (p + 1) / 2 for p, n in zip(paths, n_pilots))
    return float(nbytes), float(flops)
