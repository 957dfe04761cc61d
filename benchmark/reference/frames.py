"""The frames of a batch, from the benchmark's draws.

* the pilot pattern: the n = int(S·K·density) smallest pilot uniforms of
  each frame (n in float32), found as the port defines it: 25 float32
  bisections of the threshold, then the elements under it kept by linear
  index up to n (a frozen copy of the scattered rule, so that ties fall
  the same way), listed in a fixed table of int(S·K·max_density) slots;
* the transmitted grid x = exp(j·phase), the same on every TX antenna;
* the Jakes sum-of-sinusoids gains at each symbol's first sample,
  g = amp/√(2·O)·Σ_o exp(j(2π·fd·cos(α_o)·t + φ_o)) (E|g|² = ½·amp²);
* the channel H[s, r, t, k] = Σ_p g[s, r, t, p]·F[p, k];
* the received grid y = (Σ_t H_t)·x + n, the noise at each frame's
  measured mean received power over the SNR.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .carrier import Carrier
from .precision import Precision


class Pattern(NamedTuple):
    mask: torch.Tensor  # (B, S, K) float32
    positions: torch.Tensor  # (B, P_max, 2) int32
    valid: torch.Tensor  # (B, P_max) float32
    num_pilots: torch.Tensor  # (B,) int32


def num_pilots(total: int, density: torch.Tensor) -> torch.Tensor:
    """int(total·density) with the product in float32."""
    return torch.floor(total * density.to(torch.float32)).to(torch.int32)


def pilot_pattern(u: torch.Tensor, carrier: Carrier, density: torch.Tensor) -> Pattern:
    """The scattered pilots of uniforms ``u`` (B, S·K) float32 at each
    frame's ``density`` (B,)."""
    b, total = u.shape
    s, k = carrier.num_symbols, carrier.num_subcarriers
    p_max = carrier.max_pilots
    n = num_pilots(total, density.to(u.device))
    lo = torch.zeros(b, dtype=torch.float32, device=u.device)
    hi = torch.ones(b, dtype=torch.float32, device=u.device)
    for _ in range(25):
        mid = 0.5 * (lo + hi)
        enough = (u < mid[:, None]).sum(dim=1) >= n
        lo, hi = torch.where(enough, lo, mid), torch.where(enough, mid, hi)
    under = u < hi[:, None]
    rank = torch.cumsum(under.to(torch.int64), dim=1) - 1
    chosen = under & (rank < n[:, None])
    mask = chosen.reshape(b, s, k).to(torch.float32)
    positions = torch.zeros(b, p_max, 2, dtype=torch.int32, device=u.device)
    for f in range(b):
        lin = torch.nonzero(chosen[f]).flatten()[:p_max]
        positions[f, :len(lin), 0] = (lin // k).to(torch.int32)
        positions[f, :len(lin), 1] = (lin % k).to(torch.int32)
    slots = torch.arange(p_max, device=u.device)
    valid = (slots[None, :] < n[:, None]).to(torch.float32)
    return Pattern(mask, positions, valid, n)


def tx_grid(tx_phase: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(B, S, K) transmitted grid from the (B, S, 1, K) phases."""
    return torch.exp(1j * tx_phase[:, :, 0, :].to(prec.real))


def path_gains(angles: torch.Tensor, phases: torch.Tensor, doppler_hz: torch.Tensor,
               amp: torch.Tensor, carrier: Carrier, prec: Precision) -> torch.Tensor:
    """(B, S, R, T, P) gains at each symbol's first sample from the
    (B, P, R, T, O) oscillator angles and phases."""
    real = prec.real
    o = angles.shape[-1]
    t = torch.arange(carrier.num_symbols, dtype=real, device=angles.device)
    t = t * (carrier.samples_per_symbol / carrier.sampling_rate)
    omega = 2.0 * math.pi * doppler_hz.to(real)[:, None, None, None, None] * torch.cos(
        angles.to(real))
    arg = omega[:, None] * t[None, :, None, None, None, None] + phases.to(real)[:, None]
    g = torch.exp(1j * arg).sum(dim=-1) / math.sqrt(2.0 * o)  # (B, S, P, R, T)
    g = g * amp.to(real)[:, None, :, None, None]
    return g.permute(0, 1, 3, 4, 2)


def channel(gains: torch.Tensor, f: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(B, S, R, T, K) = Σ_p gains (B, S, R, T, P) · F (B, P, K)."""
    return prec.einsum("bsrtp,bpk->bsrtk", gains, f)


def received(h: torch.Tensor, x: torch.Tensor, snr_db: torch.Tensor, noise_re: torch.Tensor,
             noise_im: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(B, S, R, K) received grid: y = Σ_t H_t·x, plus complex noise of
    standard deviation √(P/SNR/2) a part, P each frame's mean |y|²."""
    y = h.sum(dim=3) * x[:, :, None, :].to(h.dtype)
    power = (y.abs() ** 2).mean(dim=(1, 2, 3))
    snr = 10.0 ** (snr_db.to(prec.real) / 10.0)
    std = torch.sqrt(power / snr / 2.0)
    noise = torch.complex(noise_re.to(prec.real), noise_im.to(prec.real))
    return y + noise * std[:, None, None, None]
