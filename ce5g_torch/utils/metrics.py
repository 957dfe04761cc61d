"""Channel-estimation metrics (reference: src/utils.py:161-170).

Reductions run over every axis unless ``axes`` is given.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

_EPS = 1e-12


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
