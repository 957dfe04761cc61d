"""OFDM modulation and demodulation as batched FFTs.

Port of ``ce5g_tpu.physics.ofdm`` (reference src/channel_simulator.py:130-203):

  modulate:   scatter the used bins → ifftshift → IFFT · √N → prepend the
              last ``cp_length`` samples as the cyclic prefix
  demodulate: strip the CP → FFT / √N → fftshift → gather the used bins

The shifts are permutations, so the used bins are scattered to and
gathered from their unshifted FFT positions directly (the ``raw`` bins of
``used_subcarrier_bins``: 600 centred bins minus DC → 599), which gives
the same numbers.
"""
from __future__ import annotations

import functools
import math

import torch

from ..config import OFDMConfig
from .profiles import used_subcarrier_bins


@functools.lru_cache(maxsize=16)
def _raw_bins(fft_size: int, useful_subcarriers: int, device: torch.device) -> torch.Tensor:
    """The used bins' FFT positions on ``device``, copied there once."""
    _, raw = used_subcarrier_bins(fft_size, useful_subcarriers)
    return torch.as_tensor(raw, device=device)


def modulate(symbols: torch.Tensor, cfg: OFDMConfig) -> torch.Tensor:
    """Frequency-domain symbols → CP-OFDM time signal.

    Args:
        symbols: (..., num_symbols, K) complex used-subcarrier values.
    Returns:
        (..., num_symbols, fft_size + cp_length) complex64.
    """
    bins = _raw_bins(cfg.fft_size, cfg.useful_subcarriers, symbols.device)
    grid = symbols.new_zeros(symbols.shape[:-1] + (cfg.fft_size,), dtype=torch.complex64)
    grid[..., bins] = symbols.to(torch.complex64)
    time = torch.fft.ifft(grid, dim=-1) * math.sqrt(cfg.fft_size)
    return torch.cat([time[..., -cfg.cp_length:], time], dim=-1)


def demodulate(signal: torch.Tensor, cfg: OFDMConfig) -> torch.Tensor:
    """CP-OFDM time signal → used-subcarrier frequency symbols.

    Args:
        signal: (..., num_symbols, fft_size + cp_length) complex.
    Returns:
        (..., num_symbols, K) complex64.
    """
    bins = _raw_bins(cfg.fft_size, cfg.useful_subcarriers, signal.device)
    freq = torch.fft.fft(signal[..., cfg.cp_length:], dim=-1) / math.sqrt(cfg.fft_size)
    return freq[..., bins].to(torch.complex64)
