"""3GPP tapped-delay-line channel profiles (EPA / EVA / ETU).

The port's own copy of ``ce5g_tpu.physics.profiles`` (reference:
src/channel_simulator.py:41-82): per profile, the complex delay→subcarrier
matrix F[p, k] = exp(−2πj·bin_k·d_p/N_fft) over the used (DC-removed)
bins, so the frequency response is one path contraction H = g @ F.
Profiles are padded to ``MAX_PATHS``; padded paths carry zero amplitude.
``amp_overwrite`` reproduces the reference's last-path-wins collision of
paths that quantize to the same delay tap (channel_simulator.py:125).

The tables are numpy. :func:`cached` keeps the device tensors derived
from one table (its columns on the card, the estimator's packed
matrices) on the table object itself, so they are built once per table
and device rather than on every call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from ..utils.profiling import counters

MAX_PATHS = 9
PROFILE_NAMES: Tuple[str, ...] = ("EPA", "EVA", "ETU")
PROFILE_INDEX: Dict[str, int] = {n: i for i, n in enumerate(PROFILE_NAMES)}

# (delay ns, power dB) — reference channel_simulator.py:41-54.
_RAW_PROFILES = {
    "EPA": (
        np.array([0, 30, 70, 90, 110, 190, 410]) * 1e-9,
        np.array([0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8]),
    ),
    "EVA": (
        np.array([0, 30, 150, 310, 370, 710, 1090, 1730, 2510]) * 1e-9,
        np.array([0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9]),
    ),
    "ETU": (
        np.array([0, 50, 120, 200, 230, 500, 1600, 2300, 5000]) * 1e-9,
        np.array([-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0]),
    ),
}


@dataclasses.dataclass(frozen=True, eq=False)
class ProfileTable:
    """Static per-profile arrays, padded to MAX_PATHS.

    Attributes (numpy, shape (n_profiles, MAX_PATHS) unless noted):
        delay_samples: integer tap index of each path at the system fs.
        amp_overwrite: sqrt(normalized linear power), shadowed paths zeroed.
        amp_accumulate: sqrt(normalized linear power) for all paths.
        path_valid: 1.0 for real paths, 0.0 for padding.
        freq_response: complex64 (n_profiles, MAX_PATHS, K) delay→bin matrix.
        max_delay_samples: int per profile — reference CIR tail length.
    """

    delay_samples: np.ndarray
    amp_overwrite: np.ndarray
    amp_accumulate: np.ndarray
    path_valid: np.ndarray
    freq_response: np.ndarray
    max_delay_samples: np.ndarray
    sampling_rate: float
    used_bins: np.ndarray  # (K,) raw FFT bin index per used subcarrier
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)


def cached(table: ProfileTable, key, build: Callable):
    """``build()`` once per (table, key); later calls return the same value.
    Each build counts ``tables.built`` (``utils.profiling``)."""
    if key not in table._cache:
        table._cache[key] = build()
        counters["tables.built"] += 1
    return table._cache[key]


def used_subcarrier_bins(fft_size: int, useful_subcarriers: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (shifted_indices, raw_bins) of used subcarriers: the
    ``useful_subcarriers`` bins centred on DC with DC removed
    (channel_simulator.py:139-148) — 600 requested → 599 used."""
    dc = fft_size // 2
    idx = np.arange(dc - useful_subcarriers // 2, dc + useful_subcarriers // 2)
    idx = idx[idx != dc]
    raw = (idx + fft_size // 2) % fft_size
    return idx, raw


def build_profile_table(sampling_rate: float, fft_size: int, useful_subcarriers: int) -> ProfileTable:
    """Precompute the padded profile table for a given numerology."""
    n = len(PROFILE_NAMES)
    delay_samples = np.zeros((n, MAX_PATHS), dtype=np.int32)
    amp_over = np.zeros((n, MAX_PATHS), dtype=np.float32)
    amp_acc = np.zeros((n, MAX_PATHS), dtype=np.float32)
    valid = np.zeros((n, MAX_PATHS), dtype=np.float32)
    max_delay = np.zeros((n,), dtype=np.int32)

    for pi, name in enumerate(PROFILE_NAMES):
        delays, powers_db = _RAW_PROFILES[name]
        p = len(delays)
        powers_lin = 10.0 ** (powers_db / 10.0)
        powers_lin = powers_lin / powers_lin.sum()  # reference :78
        d_samp = np.round(delays * sampling_rate).astype(np.int64)  # reference :81
        amp = np.sqrt(powers_lin)

        # Last-write-wins shadowing (reference :125 assignment semantics).
        survives = np.ones(p, dtype=bool)
        for i in range(p):
            for j in range(i + 1, p):
                if d_samp[j] == d_samp[i]:
                    survives[i] = False
                    break

        delay_samples[pi, :p] = d_samp
        amp_over[pi, :p] = amp * survives
        amp_acc[pi, :p] = amp
        valid[pi, :p] = 1.0
        max_delay[pi] = int(d_samp.max())

    _, raw_bins = used_subcarrier_bins(fft_size, useful_subcarriers)
    # F[profile, path, k] = exp(-2πj · bin_k · delay_p / N)
    phase = -2.0 * np.pi * delay_samples[..., None] * raw_bins[None, None, :] / fft_size
    freq_response = np.exp(1j * phase).astype(np.complex64)

    return ProfileTable(
        delay_samples=delay_samples,
        amp_overwrite=amp_over,
        amp_accumulate=amp_acc,
        path_valid=valid,
        freq_response=freq_response,
        max_delay_samples=max_delay,
        sampling_rate=float(sampling_rate),
        used_bins=raw_bins,
    )
