"""Work of one slot-form interpolation, a frozen copy of the port's
``ops.interp.work`` taking counts instead of tensors.

Bytes: values (B, R, P) complex64, positions (B, P, 2) int32 and valid
(B, P) float32 read once, the (B, R, S, K) complex64 output written once.
Operations: every output point scores the min(C, n_valid) valid
candidates of its window (C = min(128, P)). For 'cubic' each costs the
distance (4), its min, the weight (subtract, scale, exp), its sum and
4·R multiply-adds of the re/im planes: 9 + 4·R. For 'nearest' and
'linear' each costs the distance and 1 or 3 shell comparisons, and every
point of a frame with pilots applies at least one candidate a shell (its
weight and 4·R multiply-adds); ties add more, so that term is a lower
bound.
"""
from __future__ import annotations

from typing import Sequence, Tuple

CANDIDATES = 128


def work(b: int, r: int, p: int, s: int, k: int, n_valid: Sequence[int],
         method: str) -> Tuple[float, float]:
    """(bytes, float32 operations); ``n_valid`` has one count a frame."""
    nbytes = 8 * b * r * p + 8 * b * p + 4 * b * p + 8 * b * r * s * k
    scored = s * k * sum(min(n, CANDIDATES, p) for n in n_valid)
    if method == "cubic":
        return nbytes, (9 + 4 * r) * scored
    if method not in ("nearest", "linear"):
        raise ValueError(f"unknown interpolation method {method!r}")
    shells = 1 if method == "nearest" else 3
    applied = s * k * sum(min(n, shells) for n in n_valid)
    return nbytes, (4 + shells) * scored + (1 + 4 * r) * applied
