"""The carrier's numerology and the tapped-delay-line channel profiles.

Profiles are those of 3GPP TS 36.104 Annex B.2 (EPA, EVA, ETU): relative
delays and powers. The simulator quantizes each delay to the nearest
sample at the carrier's sampling rate, normalizes the powers to one, and
where two paths fall on one sample keeps the later ('overwrite'); the
frequency response of path p at used subcarrier k is
exp(−2πj·bin_k·tap_p / N_fft), the DC bin removed from the used band.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

#: (delays in ns, powers in dB), 3GPP TS 36.104 Table B.2-1..B.2-3
PROFILES: Dict[str, Tuple[Tuple[float, ...], Tuple[float, ...]]] = {
    "EPA": ((0, 30, 70, 90, 110, 190, 410), (0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8)),
    "EVA": ((0, 30, 150, 310, 370, 710, 1090, 1730, 2510),
            (0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9)),
    "ETU": ((0, 50, 120, 200, 230, 500, 1600, 2300, 5000),
            (-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0)),
}
#: paths a profile is padded to (the longest profile's); padding has zero power
MAX_PATHS = 9


@dataclasses.dataclass(frozen=True)
class Carrier:
    """An OFDM carrier and its antennas, from a configuration file."""

    fft_size: int
    cp_length: int
    num_symbols: int
    useful_subcarriers: int
    subcarrier_spacing: float
    num_tx: int
    num_rx: int
    num_oscillators: int
    tap_collision: str
    max_density: float

    @classmethod
    def from_config(cls, config: Dict) -> "Carrier":
        return cls(**{f.name: config[f.name] for f in dataclasses.fields(cls)})

    @property
    def sampling_rate(self) -> float:
        return self.fft_size * self.subcarrier_spacing

    @property
    def samples_per_symbol(self) -> int:
        return self.fft_size + self.cp_length

    @property
    def symbol_duration(self) -> float:
        return self.samples_per_symbol / self.sampling_rate

    @property
    def used_bins(self) -> np.ndarray:
        """FFT bin of each used subcarrier: the band centred on DC, DC removed."""
        dc = self.fft_size // 2
        idx = np.arange(dc - self.useful_subcarriers // 2, dc + self.useful_subcarriers // 2)
        idx = idx[idx != dc]
        return (idx + self.fft_size // 2) % self.fft_size

    @property
    def num_subcarriers(self) -> int:
        return len(self.used_bins)

    @property
    def max_pilots(self) -> int:
        """Pilot slots a frame holds: int(S·K·max_density)."""
        return int(self.num_symbols * self.num_subcarriers * self.max_density)


def path_taps_amps(profile: str, carrier: Carrier) -> Tuple[np.ndarray, np.ndarray]:
    """(taps, amplitudes) of ``profile``'s paths, padded to MAX_PATHS:
    delays quantized to samples, amplitudes √(normalized power), a path
    shadowed by a later one on the same tap zeroed under 'overwrite'."""
    delays_ns, powers_db = PROFILES[profile]
    power = 10.0 ** (np.asarray(powers_db) / 10.0)
    power = power / power.sum()
    taps = np.round(np.asarray(delays_ns) * 1e-9 * carrier.sampling_rate).astype(np.int64)
    amp = np.sqrt(power)
    if carrier.tap_collision == "overwrite":
        for i in range(len(taps)):
            if np.any(taps[i + 1:] == taps[i]):
                amp[i] = 0.0
    elif carrier.tap_collision != "accumulate":
        raise ValueError(f"unknown tap collision rule {carrier.tap_collision!r}")
    pad = MAX_PATHS - len(taps)
    return np.pad(taps, (0, pad)), np.pad(amp, (0, pad))


def profile_tables(profiles: Sequence[str], carrier: Carrier, device,
                   real: torch.dtype = torch.float64, complex_: torch.dtype = torch.complex128):
    """(amp (C, P), F (C, P, K)) for each named profile, on ``device``."""
    amps, fs = [], []
    bins = carrier.used_bins.astype(np.float64)
    for name in profiles:
        taps, amp = path_taps_amps(name, carrier)
        phase = -2.0 * math.pi * taps[:, None] * bins[None, :] / carrier.fft_size
        amps.append(amp)
        fs.append(np.exp(1j * phase))
    amp_t = torch.as_tensor(np.stack(amps), dtype=real, device=device)
    f_t = torch.as_tensor(np.stack(fs), dtype=complex_, device=device)
    return amp_t, f_t
