"""Channel-estimation metrics (reference: src/utils.py:161-170).

Reductions run over every axis unless ``axes`` is given.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

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
