"""Gray-coded QAM modulation and minimum-distance demodulation.

Port of ``ce5g_tpu.utils.qam`` (reference src/utils.py:71-153): QPSK and
16-QAM with the reference's Gray maps, and 64-QAM (declared in the
reference config, experiment_config.yaml:33, never implemented there),
with the same tables. The demodulator takes the first of equally near
points, as ``jnp.argmin`` does (``torch.argmin`` returns the first
minimum too).
"""
from __future__ import annotations

import numpy as np
import torch

_SQRT2 = np.sqrt(2.0)
_SQRT10 = np.sqrt(10.0)
_SQRT42 = np.sqrt(42.0)

# QPSK (reference: utils.py:93-94)
_QPSK_CONST = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j]) / _SQRT2
_QPSK_GRAY = np.array([0, 1, 3, 2])

# 16-QAM (reference: utils.py:96-102)
_QAM16_CONST = (
    np.array(
        [
            -3 - 3j, -3 - 1j, -3 + 3j, -3 + 1j,
            -1 - 3j, -1 - 1j, -1 + 3j, -1 + 1j,
            3 - 3j, 3 - 1j, 3 + 3j, 3 + 1j,
            1 - 3j, 1 - 1j, 1 + 3j, 1 + 1j,
        ]
    )
    / _SQRT10
)
_QAM16_GRAY = np.array([0, 1, 3, 2, 4, 5, 7, 6, 12, 13, 15, 14, 8, 9, 11, 10])


def _gray64() -> tuple[np.ndarray, np.ndarray]:
    # Separable Gray mapping per I/Q axis, standard 64-QAM.
    levels = np.array([-7, -5, -3, -1, 1, 3, 5, 7])
    gray3 = np.array([0, 1, 3, 2, 6, 7, 5, 4])  # 3-bit Gray sequence
    const = np.empty(64, dtype=complex)
    gray = np.empty(64, dtype=int)
    for i in range(8):
        for q in range(8):
            idx = i * 8 + q
            const[idx] = (levels[i] + 1j * levels[q]) / _SQRT42
            gray[idx] = gray3[i] * 8 + gray3[q]
    return const, gray


_QAM64_CONST, _QAM64_GRAY = _gray64()

_TABLES = {
    4: (_QPSK_CONST, _QPSK_GRAY),
    16: (_QAM16_CONST, _QAM16_GRAY),
    64: (_QAM64_CONST, _QAM64_GRAY),
}


def bits_per_symbol(M: int) -> int:
    return int(np.log2(M))


def _table(M: int, what: str):
    if M not in _TABLES:
        raise NotImplementedError(f"{what} order {M} not implemented")
    return _TABLES[M]


def qam_modulate(bits, M: int = 4) -> torch.Tensor:
    """Map bits (..., N) to Gray-coded M-QAM symbols (..., N // log2 M),
    complex64, on the bits' device. Trailing bits short of a symbol are
    dropped."""
    const, gray = _table(M, "Modulation")
    k = bits_per_symbol(M)
    bits = torch.as_tensor(bits)
    dev = bits.device
    n_sym = bits.shape[-1] // k
    bit_matrix = bits[..., : n_sym * k].reshape(*bits.shape[:-1], n_sym, k).long()
    weights = 2 ** torch.arange(k - 1, -1, -1, device=dev)
    decimal = (bit_matrix * weights).sum(dim=-1)
    mapped = torch.as_tensor(gray, device=dev)[decimal]
    return torch.as_tensor(const.astype(np.complex64), device=dev)[mapped]


def qam_demodulate(symbols, M: int = 4) -> torch.Tensor:
    """Minimum-distance demodulation (reference: utils.py:112-153) of
    (..., N) symbols to (..., N · log2 M) int64 bits."""
    const, gray = _table(M, "Demodulation")
    k = bits_per_symbol(M)
    symbols = torch.as_tensor(symbols)
    dev = symbols.device
    points = torch.as_tensor(const, device=dev).to(symbols.dtype)
    detected = (symbols[..., None] - points).abs().argmin(dim=-1)
    inverse_gray = torch.as_tensor(np.argsort(gray), device=dev)
    decimal = inverse_gray[detected]
    shifts = torch.arange(k - 1, -1, -1, device=dev)
    bits = (decimal[..., None] >> shifts) & 1
    return bits.reshape(*symbols.shape[:-1], -1)
