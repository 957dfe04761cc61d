"""The channel estimates, from the reference's own frames.

* LS at the pilots, h = y / (x + 1e-12), one estimate per RX antenna,
  broadcast over TX (a common grid on every TX antenna cannot separate
  them).
* 'linear' / 'nearest' in grid form: frozen copies of the port's plain
  ``ops.interp_fused.grid_weights`` (per-row nearest-pilot fills, a
  tied-shell k-NN over the row candidates) applied to the masked LS grid.
* any method in slot form: frozen copies of the port's plain
  ``ops.interp.candidate_table`` and ``selection_weights`` (a window of
  128 consecutive pilots sorted by subcarrier; Gaussian weights for
  'cubic') applied to the LS values at the slots.
* 'mmse_full': the linear MMSE estimate of each TX channel from the
  pilots' LS values, Ĥ_t = L·(T·ΦᴴΦ + σ²I)⁻¹·Φᴴh, where the prior
  Cov(H_t) = (V·Vᵀ) ⊗ R_f has R_f[k, k'] = Σ_p w_p·F[p, k]·F*[p, k']
  (w_p = ½·amp², the Jakes path power) and V·Vᵀ is the time correlation
  R_t[s, s'] = J0(2π·fd·(s − s')·T_sym) projected on the orthonormal
  Legendre polynomials of degree < m and ridged by 1e-4·trace/m + 1e-6,
  with m the least rank that holds the configured Doppler's R_t within
  1e-5 (relative Frobenius); L[(s, k), (p, m)] = √w_p·F[p, k]·V[s, m],
  Φ its rows at the valid pilots, σ² = T·Σw / SNR. Each frame's system is
  solved by LU (``torch.linalg.solve``) on pilots gathered by position.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from .carrier import Carrier
from .frames import Pattern
from .precision import Precision

_EPS = 1e-12
_CANDIDATES = 128


# ---------------------------------------------------------------- LS

def ls_at_pilots(y: torch.Tensor, x: torch.Tensor, pattern: Pattern) -> torch.Tensor:
    """(B, R, P_max) LS values at the pilot slots, zero at invalid ones."""
    b, s, r, k = y.shape
    lin = pattern.positions[..., 0].long() * k + pattern.positions[..., 1].long()
    y_flat = y.permute(0, 2, 1, 3).reshape(b, r, s * k)
    y_p = y_flat.gather(-1, lin[:, None, :].expand(b, r, -1))
    x_p = x.reshape(b, s * k).gather(-1, lin)
    return y_p / (x_p + _EPS)[:, None, :] * pattern.valid.to(y.real.dtype)[:, None, :]


# ---------------------------------------------------------------- grid form

def _fills(ok: torch.Tensor):
    """Nearest and second-nearest pilot column at-or-left and at-or-right
    of each column of ``ok`` (B, S, K); −1 where none."""
    k = ok.shape[-1]
    iota = torch.arange(k, device=ok.device)
    none = torch.full_like(iota, -1)
    p1l = torch.where(ok, iota, none).cummax(dim=-1).values
    rev = torch.where(ok.flip(-1), iota, none).cummax(dim=-1).values
    p1r = torch.where(rev >= 0, k - 1 - rev, none).flip(-1)
    prev = torch.cat([torch.full_like(p1l[..., :1], -1), p1l[..., :-1]], dim=-1)
    nxt = torch.cat([p1r[..., 1:], torch.full_like(p1r[..., :1], -1)], dim=-1)
    p2l = torch.where(p1l >= 0, prev.gather(-1, p1l.clamp(min=0)), -1)
    p2r = torch.where(p1r >= 0, nxt.gather(-1, p1r.clamp(min=0)), -1)
    return p1l, p2l, p1r, p2r


def grid_weights(mask: torch.Tensor, method: str, real: torch.dtype = torch.float64):
    """(w (B, S_out, C, K) normalized k-NN weights over the C = sides·S
    row candidates, pos (B, S, sides, K) their pilot columns, −1 absent)."""
    b, s, k = mask.shape
    ok = mask > 0
    p1l, p2l, p1r, p2r = _fills(ok)
    cols = torch.arange(k, device=mask.device, dtype=real)
    inf = torch.tensor(float("inf"), device=mask.device, dtype=real)

    def left(p):
        return torch.where(p >= 0, cols - p, inf)

    def right(p):
        return torch.where(p >= 0, p - cols, inf)

    d_1r = torch.where(p1r == p1l, inf, right(p1r))  # a pilot on the column counts once
    if method == "nearest":
        d_sides, p_sides = [left(p1l), d_1r], [p1l, p1r]
    elif method == "linear":
        d_sides = [left(p1l), left(p2l), d_1r, right(p2r)]
        p_sides = [p1l, p2l, p1r, p2r]
    else:
        raise ValueError(f"grid form takes 'nearest' or 'linear', not {method!r}")
    sides = len(d_sides)
    d1 = torch.stack(d_sides, dim=-2).reshape(b, sides * s, k)
    rows = torch.arange(s, device=mask.device, dtype=real)
    drow = rows[:, None] - rows.repeat_interleave(sides)[None, :]
    d2 = drow[None, :, :, None] ** 2 + d1[:, None, :, :] ** 2  # (B, S_out, C, K)
    fin = torch.isfinite(d2)
    m1 = d2.amin(dim=2, keepdim=True)
    if method == "nearest":
        w = ((d2 <= m1) & fin).to(real)
    else:
        m2 = torch.where(d2 > m1, d2, inf).amin(dim=2, keepdim=True)
        m3 = torch.where(d2 > m2, d2, inf).amin(dim=2, keepdim=True)
        zero = torch.zeros((), device=mask.device, dtype=real)
        w = torch.where(fin & (d2 <= m1), 1.0 / (m1 + 1e-6), zero)
        w = w + torch.where(fin & (d2 > m1) & (d2 <= m2), 1.0 / (m2 + 1e-6), zero)
        w = w + torch.where(fin & (d2 > m2) & (d2 <= m3), 1.0 / (m3 + 1e-6), zero)
    w = w / w.sum(dim=2, keepdim=True).clamp(min=1e-12)
    return w, torch.stack(p_sides, dim=-2)


def interpolate_grid(values: torch.Tensor, mask: torch.Tensor, method: str,
                     prec: Precision) -> torch.Tensor:
    """(B, R, S, K) grid from the masked values (B, R, S, K)."""
    b, r, s, k = values.shape
    w, pos = grid_weights(mask, method, prec.real)
    sides = pos.shape[2]
    idx = pos.clamp(min=0)[:, None].expand(b, r, s, sides, k)
    src = values[:, :, :, None, :].expand(b, r, s, sides, k)
    cand = src.gather(-1, idx).reshape(b, r, s * sides, k)
    return prec.einsum("bsck,brck->brsk", w, cand)


# ---------------------------------------------------------------- slot form

def candidate_table(positions: torch.Tensor, valid: torch.Tensor, k: int):
    """(B, K, C) candidate slots of each column (the C = min(128, P)
    consecutive valid pilots sorted by subcarrier around it) and whether
    each is a valid pilot."""
    b, p = valid.shape
    c = min(_CANDIDATES, p)
    ok = valid > 0
    key = torch.where(ok, positions[..., 1].to(torch.float64), float("inf"))
    order = torch.argsort(key, dim=-1, stable=True)
    key_sorted = key.gather(-1, order)
    cols = torch.arange(k, dtype=torch.float64, device=valid.device)
    pos = torch.searchsorted(key_sorted, cols.expand(b, -1).contiguous())
    n_valid = ok.sum(-1, keepdim=True)
    start = torch.minimum((pos - c // 2).clamp(min=0), (n_valid - c).clamp(min=0))
    cand_sorted = start[..., None] + torch.arange(c, device=valid.device)
    cand = order.gather(-1, cand_sorted.reshape(b, -1)).reshape(cand_sorted.shape)
    return cand, cand_sorted < n_valid[..., None]


def selection_weights(d2: torch.Tensor, method: str) -> torch.Tensor:
    """Normalized weights over the last axis of ``d2`` (+inf: absent)."""
    inf = torch.tensor(float("inf"), device=d2.device, dtype=d2.dtype)
    if method == "cubic":
        mn = d2.amin(dim=-1, keepdim=True)
        mn = torch.where(torch.isfinite(mn), mn, 0.0)
        w = torch.exp(-(d2 - mn) / (4.0 * (mn + 1.0)))
        w = torch.where(torch.isfinite(d2), w, 0.0)
    elif method in ("nearest", "linear"):
        remaining = d2
        w = torch.zeros_like(d2)
        for _ in range(1 if method == "nearest" else 3):
            mn = remaining.amin(dim=-1, keepdim=True)
            sel = (remaining <= mn) & torch.isfinite(remaining)
            w = w + (sel.to(d2.dtype) if method == "nearest" else sel / (mn + 1e-6))
            remaining = torch.where(sel, inf, remaining)
    else:
        raise ValueError(f"unknown interpolation method {method!r}")
    return w / w.sum(dim=-1, keepdim=True).clamp(min=1e-12)


def interpolate_slots(values: torch.Tensor, pattern: Pattern, s: int, k: int, method: str,
                      prec: Precision) -> torch.Tensor:
    """(B, R, S, K) grid from the slot values (B, R, P_max)."""
    b, r, _ = values.shape
    cand, ok = candidate_table(pattern.positions, pattern.valid, k)
    c = cand.shape[-1]
    pos = pattern.positions.to(prec.real)
    flat = cand.reshape(b, -1)
    cand_sy = pos[..., 0].gather(-1, flat).reshape(b, 1, k, c)
    cand_sc = pos[..., 1].gather(-1, flat).reshape(b, 1, k, c)
    rows = torch.arange(s, dtype=prec.real, device=values.device)[:, None, None]
    cols = torch.arange(k, dtype=prec.real, device=values.device)[None, :, None]
    d2 = (rows - cand_sy) ** 2 + (cols - cand_sc) ** 2  # (B, S, K, C)
    d2 = torch.where(ok[:, None], d2, float("inf"))
    w = selection_weights(d2, method)
    v = values.gather(-1, flat[:, None, :].expand(b, r, -1)).reshape(b, r, k, c)
    return prec.einsum("bskc,brkc->brsk", w, v)


def ls_estimate(y, x, pattern: Pattern, method: str, grid_form: bool,
                prec: Precision) -> torch.Tensor:
    """(B, S, R, K) LS estimate, interpolated in grid or slot form."""
    b, s, r, k = y.shape
    if grid_form:
        m = pattern.mask.to(prec.real)
        g = m[:, None] * (y.permute(0, 2, 1, 3) / (x + _EPS)[:, None])
        h = interpolate_grid(g, pattern.mask, method, prec)
    else:
        h = interpolate_slots(ls_at_pilots(y, x, pattern), pattern, s, k, method, prec)
    return h.permute(0, 2, 1, 3)


# ---------------------------------------------------------------- Wiener

def legendre_basis(s: int, m: int) -> np.ndarray:
    """(S, m) orthonormal basis of the polynomials of degree < m on S
    equispaced points of [−1, 1]."""
    x = np.linspace(-1.0, 1.0, s)
    q, _ = np.linalg.qr(np.polynomial.legendre.legvander(x, m - 1))
    return q


def time_correlation(doppler_hz: torch.Tensor, carrier: Carrier) -> torch.Tensor:
    """(B, S, S) R_t = J0(2π·fd·(s − s')·T_sym), float64."""
    ds = torch.arange(carrier.num_symbols, dtype=torch.float64, device=doppler_hz.device)
    tau = (2.0 * math.pi * doppler_hz.to(torch.float64))[:, None, None] * (
        ds[:, None] - ds[None, :]) * carrier.symbol_duration
    return torch.special.bessel_j0(tau)


def time_rank(carrier: Carrier, doppler_configured: Sequence[float]) -> Optional[int]:
    """The least m < S whose Legendre projection holds the largest
    configured Doppler's R_t within 1e-5 (relative Frobenius); None (full
    rank) if none does."""
    s = carrier.num_symbols
    rt = time_correlation(torch.tensor([max(doppler_configured)]), carrier)[0].numpy()
    norm = np.linalg.norm(rt)
    for m in range(2, s):
        q = legendre_basis(s, m)
        if np.linalg.norm(q @ (q.T @ rt @ q) @ q.T - rt) <= 1e-5 * norm:
            return m
    return None


def time_factor(doppler_hz: torch.Tensor, carrier: Carrier, rank: Optional[int],
                prec: Precision) -> torch.Tensor:
    """(B, S, m) V with V·Vᵀ the ridged rank-m projection of R_t."""
    rt = time_correlation(doppler_hz, carrier)
    s = carrier.num_symbols
    if rank is None or rank >= s:
        q = torch.eye(s, dtype=torch.float64, device=rt.device)
        rank = s
    else:
        q = torch.as_tensor(legendre_basis(s, rank), device=rt.device)
    proj = q.T @ rt @ q
    ridge = 1e-4 * proj.diagonal(dim1=-2, dim2=-1).sum(-1) / rank + 1e-6
    eye = torch.eye(rank, dtype=torch.float64, device=rt.device)
    v = q @ torch.linalg.cholesky(proj + ridge[:, None, None] * eye)
    return v.to(prec.real)


def mmse_full(y, x, pattern: Pattern, amp, f, doppler_hz, snr_db, carrier: Carrier,
              rank: Optional[int], prec: Precision) -> torch.Tensor:
    """(B, S, R, K) Wiener estimate of each TX channel (module note).

    ``amp`` (B, P) and ``f`` (B, P, K) are each frame's profile's path
    amplitudes and delay→subcarrier matrix."""
    b, s, r, k = y.shape
    t = carrier.num_tx
    v = time_factor(doppler_hz, carrier, rank, prec)  # (B, S, m)
    w = 0.5 * amp.to(prec.real) ** 2  # (B, P)
    sw = torch.sqrt(w)
    h_p = ls_at_pilots(y, x, pattern)  # (B, R, Pmax)
    sy = pattern.positions[..., 0].long()
    sc = pattern.positions[..., 1].long()
    valid = pattern.valid.to(prec.real)
    f_p = f.to(prec.complex).gather(-1, sc[:, None, :].expand(-1, f.shape[1], -1))  # (B, P, Pmax)
    v_p = v.gather(1, sy[:, :, None].expand(-1, -1, v.shape[-1]))  # (B, Pmax, m)
    phi = (sw[:, :, None] * f_p).transpose(1, 2)[:, :, :, None] * v_p[:, :, None, :]
    phi = phi * valid[:, :, None, None]
    phi = phi.reshape(b, phi.shape[1], -1)  # (B, Pmax, P·m)
    n = phi.shape[-1]
    sigma2 = (t * w.sum(-1) / 10.0 ** (snr_db.to(prec.real) / 10.0)).clamp(min=1e-8)
    gram = t * prec.einsum("bin,bio->bno", phi.conj(), phi)
    gram = gram + sigma2[:, None, None] * torch.eye(n, dtype=gram.dtype, device=gram.device)
    rhs = prec.einsum("bin,bri->bnr", phi.conj(), h_p)
    c = torch.linalg.solve(gram, rhs)  # (B, P·m, R)
    c = c.reshape(b, w.shape[1], v.shape[-1], r) * sw[:, :, None, None]
    h_sp = prec.einsum("bsm,bpmr->bsrp", v, c)
    return prec.einsum("bsrp,bpk->bsrk", h_sp, f)
