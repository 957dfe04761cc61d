"""Work of one batched HPD solve, a frozen copy of the port's
``ops.hpd_solve.work``: A (B, n, n) and B (B, n, R) complex64 read once,
X written once; the Cholesky n³/6 and the two substitutions n²·R/2 each
in complex multiply-adds of 8 real operations, whatever route runs it."""
from __future__ import annotations

from typing import Tuple


def work(b: int, n: int, r: int) -> Tuple[float, float]:
    """(bytes, float32 operations)."""
    nbytes = 8 * b * (n * n + 2 * n * r)
    flops = 8 * b * (n ** 3 / 6 + n * n * r)
    return nbytes, flops
