"""Channel-estimation metrics (reference: src/utils.py:156-170,
src/baseline_estimators.py:315-337).

Reductions run over every axis unless ``axes`` is given.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..device import resolve_device

_EPS = 1e-12


def db2linear(db):
    """10^(x/10) (reference: src/utils.py:39-41)."""
    return 10.0 ** (torch.as_tensor(db) / 10.0)


def linear2db(x):
    """10·log10(x + 1e-12) (reference: src/utils.py:44-46)."""
    return 10.0 * torch.log10(torch.as_tensor(x) + _EPS)


def mse(h_true, h_est, axes: Optional[Sequence[int]] = None):
    """Mean |H_true − H_est|² (reference: src/utils.py:161-163)."""
    err = (h_true - h_est).abs() ** 2
    return err.mean() if axes is None else err.mean(dim=tuple(axes))


def nmse(h_true, h_est, axes: Optional[Sequence[int]] = None):
    """MSE / mean|H_true|² (reference: src/utils.py:166-170)."""
    pwr = h_true.abs() ** 2
    p = pwr.mean() if axes is None else pwr.mean(dim=tuple(axes))
    return mse(h_true, h_est, axes) / (p + _EPS)


def nmse_db(h_true, h_est, axes: Optional[Sequence[int]] = None):
    return linear2db(nmse(h_true, h_est, axes))


def ber_approximation(snr_db, nmse_linear):
    """Analytic BER proxy of the reference evaluation
    (run_phase5_evaluation.py:57-68): the effective SNR degraded by the
    channel-estimation error, then ½·exp(−SNR_eff/2), clipped to
    [1e-6, 0.5]."""
    snr_lin = db2linear(snr_db)
    eff = snr_lin / (1.0 + snr_lin * torch.as_tensor(nmse_linear))
    return torch.clamp(0.5 * torch.exp(-eff / 2.0), 1e-6, 0.5)


def evaluate_estimator(h_true, h_est) -> Dict[str, torch.Tensor]:
    """MSE / NMSE / NMSE dB of one estimate over every axis
    (reference: src/baseline_estimators.py:315-337)."""
    m = mse(h_true, h_est)
    n = nmse(h_true, h_est)
    return {"mse": m, "nmse": n, "nmse_db": linear2db(n)}


def calculate_ber(tx_bits, rx_bits) -> torch.Tensor:
    """Exact bit-error rate (reference: src/utils.py:156-158)."""
    tx = torch.as_tensor(tx_bits)
    rx = torch.as_tensor(rx_bits, device=tx.device)
    return (tx != rx).sum() / tx.numel()


def awgn_noise(generator: torch.Generator, shape, snr_db, signal_power=1.0,
               device="cuda") -> torch.Tensor:
    """Complex64 AWGN of ``shape`` for an SNR and a signal power
    (reference src/utils.py:49-68), drawn with ``generator``, which must
    live on ``device``: the real parts first, then the imaginary parts."""
    dev = resolve_device(device)
    noise_power = torch.as_tensor(signal_power, dtype=torch.float32) / db2linear(
        torch.as_tensor(snr_db, dtype=torch.float32))
    std = torch.sqrt(noise_power / 2.0).to(dev)
    re = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
    im = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
    return torch.complex(re * std, im * std)
