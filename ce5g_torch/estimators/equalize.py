"""MIMO equalisation as batched small-matrix solves.

Port of ``ce5g_tpu.estimators.equalize`` (reference
src/baseline_estimators.py:273-312: per-(symbol, subcarrier) loops
forming (HᴴH + λI)⁻¹Hᴴy with λ = 1e-8 for ZF and σ² for MMSE). Every
RE's T × T system is one item of a single batched ``torch.linalg.solve``,
as the JAX package solves it with ``jnp.linalg.solve`` (no kernel of its
own there either).
"""
from __future__ import annotations

import torch


def equalize_channel(rx_symbols, h_est, method: str = "zf", noise_var: float = 0.01):
    """Equalise received symbols with an estimated channel, on their device.

    Args:
        rx_symbols: (..., S, R, K) complex.
        h_est: (..., S, R, T, K) complex.
        method: 'zf' (λ = 1e-8 ridge, reference :297) or 'mmse' (λ = σ²,
            ``noise_var``; the reference hard-codes 0.01 at :306).

    Returns:
        (..., S, T, K) complex64 equalised symbols.
    """
    if method == "zf":
        lam = 1e-8
    elif method == "mmse":
        lam = noise_var
    else:
        raise ValueError(f"Unknown equalization method: {method!r}")

    h = h_est.movedim(-1, -3)  # (..., S, K, R, T)
    y = rx_symbols.movedim(-1, -2)[..., None]  # (..., S, K, R, 1)
    hh = h.conj().transpose(-1, -2)  # (..., S, K, T, R)
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    a = hh @ h + lam * eye
    x = torch.linalg.solve(a, hh @ y)[..., 0]
    return x.movedim(-1, -2).to(torch.complex64)  # (..., S, T, K)
