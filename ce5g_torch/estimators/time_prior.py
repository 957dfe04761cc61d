"""The Wiener time prior: the time correlation of Jakes fading and the
Legendre basis that carries it at low rank.

    R_t[s1, s2] = J0(2π·fd·(s1 − s2)·T_sym)

``mmse_full`` builds R_t for each frame and projects it onto the first m
orthonormal Legendre polynomials over the S symbols (``estimators.mmse``);
the blind estimator fits its pilots in that basis and matches each
candidate Doppler's R_t in it (``estimators.blind``); and
:func:`auto_time_rank` sizes m from the configuration on the host.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..utils.profiling import counters


def bessel_j0(x: torch.Tensor) -> torch.Tensor:
    """J0 via the Abramowitz & Stegun 9.4.1 / 9.4.3 rational approximations
    (|err| < 1e-7), branch-free, valid for all real x; float32, or float64
    for a float64 x."""
    x = x.to(torch.promote_types(x.dtype, torch.float32)).abs()
    # |x| <= 3
    t = (x / 3.0) ** 2
    small = (
        1.0
        + t * (-2.2499997 + t * (1.2656208 + t * (-0.3163866
        + t * (0.0444479 + t * (-0.0039444 + t * 0.0002100)))))
    )
    # |x| > 3
    xs = x.clamp(min=3.0)
    u = 3.0 / xs
    f0 = (
        0.79788456
        + u * (-0.00000077 + u * (-0.00552740 + u * (-0.00009512
        + u * (0.00137237 + u * (-0.00072805 + u * 0.00014476)))))
    )
    th0 = (
        xs - 0.78539816
        + u * (-0.04166397 + u * (-0.00003954 + u * (0.00262573
        + u * (-0.00054125 + u * (-0.00029333 + u * 0.00013558)))))
    )
    large = f0 * torch.cos(th0) / torch.sqrt(xs)
    return torch.where(x <= 3.0, small, large)


def time_correlation(doppler_hz: torch.Tensor, num_symbols: int,
                     symbol_duration: float) -> torch.Tensor:
    """R_t of each Doppler of ``doppler_hz`` (a tensor of shape (...)):
    (..., S, S) in its dtype, on its device; 2π·fd is formed first."""
    ds = torch.arange(num_symbols, dtype=doppler_hz.dtype, device=doppler_hz.device)
    return bessel_j0(
        (2.0 * math.pi * doppler_hz)[..., None, None] * (ds[:, None] - ds[None, :])
        * symbol_duration
    )


@functools.lru_cache(maxsize=None)
def legendre_qr(num_symbols: int, rank: int) -> np.ndarray:
    """The orthonormal basis of the Legendre polynomials of degree < m over
    S equispaced points of [−1, 1]: Q of the QR of their Vandermonde,
    (S, m) float64. One array per (S, m), shared by every caller: read
    it, never write it. :func:`auto_time_rank` walks m = 2, 3, … every
    batch (66 keys over a 280-symbol frame), and an LRU cache smaller than
    a search misses on every lookup of it; the keys are few and fixed by
    the configuration, so none is dropped. Each QR built counts
    ``time_prior.legendre_built``."""
    counters["time_prior.legendre_built"] += 1
    x = np.linspace(-1.0, 1.0, num_symbols)
    q, _ = np.linalg.qr(np.polynomial.legendre.legvander(x, rank - 1))
    return q


def legendre_basis(num_symbols: int, rank: int) -> np.ndarray:
    """:func:`legendre_qr` in float32, the basis of the estimators: (S, m)."""
    return legendre_qr(num_symbols, rank).astype(np.float32)


def auto_time_rank(cfg: ExperimentConfig) -> Optional[int]:
    """Legendre-projection rank of the mmse_full time prior: the smallest
    m whose projection reconstructs the worst-case (largest configured
    Doppler) R_t within 1e-5 relative Frobenius error — m = 5 for
    fd ≤ 200 Hz and m = 8 for fd ≤ 500 Hz at the default numerology.
    None (full rank) when no m < S reaches the tolerance. Each call counts
    ``time_rank.computed`` (``utils.profiling``)."""
    counters["time_rank.computed"] += 1
    s = cfg.ofdm.num_symbols
    fd_max = torch.tensor(max(cfg.channel.doppler_hz), dtype=torch.float64)
    rt = time_correlation(fd_max, s, cfg.ofdm.symbol_duration).numpy()
    norm = np.linalg.norm(rt)
    for m in range(2, s):
        q = legendre_qr(s, m)
        rec = q @ (q.T @ rt @ q) @ q.T
        if np.linalg.norm(rec - rt) <= 1e-5 * norm:
            return m
    return None
