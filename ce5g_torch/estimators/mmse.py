"""MMSE channel estimation, batched — two modes.

Port of ``ce5g_tpu.estimators.mmse``.

1. ``mmse_diag_estimate`` — behavioural parity with the reference's
   diagonal MMSE (src/baseline_estimators.py:155-196). With a
   scaled-identity covariance the reference's dense P×P Wiener product is
   exactly the scalar shrinkage p/(p+σ²)·h_ls, computed on the masked LS
   grid (grid form) or at the pilot slots (slot form), then interpolated
   like LS.

2. ``mmse_full_estimate`` — the per-subcarrier Wiener filter with the
   simulator's exact second-order statistics,

       E[H(s1,k1) H*(s2,k2)] = R_t[s1,s2] · R_f[k1,k2],
       R_t[Δs] = J0(2π·fd·Δs·T_sym),  R_f = Σ_p w_p F[p,k1]F*[p,k2],

   solved through the Woodbury identity as one (paths·m)×(paths·m) HPD
   system per frame (m = time rank), all frames in one batched solve
   (``ops.hpd_solve``). The pilot sums are masked grid sums, so no pilot
   gather is needed (see the JAX module for the derivation).

Precision: the Woodbury path relies on the exact cancellation
(h − Φ·sol)/σ²; the entry points pin float32 matmuls to full precision
(``device.resolve_device``).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.hpd_solve import hpd_solve
from ..utils.complexify import packed_complex_matmul
from .interpolate import interpolate, interpolate_grid
from .ls import ls_at_pilots, masked_ls_grid


def bessel_j0(x: torch.Tensor) -> torch.Tensor:
    """J0 via the Abramowitz & Stegun 9.4.1 / 9.4.3 rational approximations
    (|err| < 1e-7), branch-free, valid for all real x; float32, or float64
    for a float64 x."""
    x = x.to(torch.promote_types(x.dtype, torch.float32)).abs()
    # |x| <= 3
    t = (x / 3.0) ** 2
    small = (
        1.0
        + t * (-2.2499997 + t * (1.2656208 + t * (-0.3163866
        + t * (0.0444479 + t * (-0.0039444 + t * 0.0002100)))))
    )
    # |x| > 3
    xs = x.clamp(min=3.0)
    u = 3.0 / xs
    f0 = (
        0.79788456
        + u * (-0.00000077 + u * (-0.00552740 + u * (-0.00009512
        + u * (0.00137237 + u * (-0.00072805 + u * 0.00014476)))))
    )
    th0 = (
        xs - 0.78539816
        + u * (-0.04166397 + u * (-0.00003954 + u * (0.00262573
        + u * (-0.00054125 + u * (-0.00029333 + u * 0.00013558)))))
    )
    large = f0 * torch.cos(th0) / torch.sqrt(xs)
    return torch.where(x <= 3.0, small, large)


@functools.lru_cache(maxsize=32)
def _legendre_basis_np(s: int, m: int) -> np.ndarray:
    x = np.linspace(-1.0, 1.0, s)
    q, _ = np.linalg.qr(np.polynomial.legendre.legvander(x, m - 1))
    return q.astype(np.float32)


def _legendre_basis(s: int, m: int, device) -> torch.Tensor:
    """Static orthonormal degree-(m−1) Legendre basis over s symbols: (s, m)."""
    return torch.as_tensor(_legendre_basis_np(s, m), device=device)


def mmse_diag_at_pilots(h_ls, valid, snr_db):
    """Scalar-Wiener shrinkage ≡ reference diagonal MMSE
    (baseline_estimators.py:177-194): p = mean|h_ls|² over the valid
    slots, σ² = 1/SNR_lin, h = p/(p+σ²)·h_ls.

    Args:
        h_ls: (B, R, P) complex; valid: (B, P); snr_db: (B,).
    """
    v = valid.to(torch.float32)[:, None]
    n = v.sum(dim=-1, keepdim=True).clamp(min=1.0)
    p = (h_ls.abs() ** 2 * v).sum(dim=-1, keepdim=True) / n
    snr = torch.as_tensor(snr_db, dtype=torch.float32, device=h_ls.device)
    sigma2 = (10.0 ** (-snr / 10.0))[:, None, None]
    return h_ls * (p / (p + sigma2))


def mmse_diag_estimate(
    rx_symbols, tx_grid, positions, valid, grid_shape: Tuple[int, int], num_tx: int,
    snr_db, method: str = "linear", pilot_mask=None,
):
    """Reference-parity MMSE: LS → scalar shrink → interpolate
    (baseline_estimators.py:232-270).

    Args:
        rx_symbols: (B, S, R, K); tx_grid: (B, S, K); positions: (B, P, 2);
            valid: (B, P); grid_shape: (S, K); snr_db: (B,).
        pilot_mask: optional (B, S, K). With it, and 'nearest' or 'linear',
            the shrink and the interpolation run in grid form; otherwise in
            slot form (see ``ls_estimate``).

    Returns:
        (B, S, R, T, K) complex64.
    """
    if pilot_mask is not None and method in ("nearest", "linear"):
        m = pilot_mask.to(torch.float32)
        g = masked_ls_grid(rx_symbols, tx_grid, m)  # (B, R, S, K)
        n = m.sum(dim=(-2, -1)).clamp(min=1.0)[:, None, None, None]
        p = (g.abs() ** 2).sum(dim=(-2, -1), keepdim=True) / n  # per rx antenna
        snr = torch.as_tensor(snr_db, dtype=torch.float32, device=g.device)
        sigma2 = (10.0 ** (-snr / 10.0))[:, None, None, None]
        h_full = interpolate_grid(g * (p / (p + sigma2)), m, method)
    else:
        h_ls = ls_at_pilots(rx_symbols.transpose(1, 2), tx_grid, positions, valid)
        h_mmse = mmse_diag_at_pilots(h_ls, valid, snr_db)
        h_full = interpolate(h_mmse, positions, valid, grid_shape, method)
    h_full = h_full.transpose(1, 2)  # (B, S, R, K)
    b, s, r, k = h_full.shape
    return h_full[:, :, :, None, :].expand(b, s, r, num_tx, k)


class FTables(NamedTuple):
    """Packed all-profile delay→bin tables for the E and D contractions."""

    w_e: torch.Tensor  # (2K, 2·C·P) float32
    w_d: torch.Tensor  # (K, 2·C·P·P) float32
    num_profiles: int
    num_paths: int


def build_f_tables(f_table: np.ndarray, device) -> FTables:
    """Build the static tables of ``mmse_full_estimate`` from the
    (C, P, K) complex delay→bin table of every profile (mmse.py:339-364):

        e = Σ_k g·conj(F)        → [Re g, Im g] @ w_e
        d = Σ_k m·conj(F_p)·F_q  → m @ w_d

    They depend only on the profile table: build them once per table and
    device (``estimators.api`` caches them on the table).
    """
    ft = np.asarray(f_table)
    c_num, p_num, k_num = ft.shape
    frt = np.real(ft).transpose(2, 0, 1).reshape(k_num, c_num * p_num)
    fit = np.imag(ft).transpose(2, 0, 1).reshape(k_num, c_num * p_num)
    # e = Σ_k g·conj(F): Re = gr@fr + gi@fi ; Im = gi@fr − gr@fi
    w_e = np.concatenate(
        [
            np.concatenate([frt, -fit], axis=1),  # gr rows
            np.concatenate([fit, frt], axis=1),  # gi rows
        ],
        axis=0,
    ).astype(np.float32)
    a_re = np.einsum("cpk,cqk->kcpq", np.real(ft), np.real(ft)) + np.einsum(
        "cpk,cqk->kcpq", np.imag(ft), np.imag(ft)
    )
    a_im = np.einsum("cpk,cqk->kcpq", np.real(ft), np.imag(ft)) - np.einsum(
        "cpk,cqk->kcpq", np.imag(ft), np.real(ft)
    )
    w_d = np.concatenate(
        [a_re.reshape(k_num, -1), a_im.reshape(k_num, -1)], axis=1
    ).astype(np.float32)
    return FTables(
        torch.as_tensor(w_e, device=device),
        torch.as_tensor(w_d, device=device),
        c_num,
        p_num,
    )


def _split_complex(x: torch.Tensor) -> torch.Tensor:
    """(..., 2N) real [re | im] → (..., N) complex."""
    re, im = x.chunk(2, dim=-1)
    return torch.complex(re, im)


def mmse_full_estimate(
    rx_symbols,
    tx_grid,
    pilot_mask,
    num_tx: int,
    snr_db,
    freq_matrix,
    amp,
    doppler_hz,
    symbol_duration: float,
    time_rank: "int | None" = None,
    f_tables: Optional[FTables] = None,
    profile_idx=None,
):
    """Full per-subcarrier Wiener MMSE with channel-correlation priors.

    Args:
        rx_symbols: (B, S, R, K) complex; tx_grid, pilot_mask: (B, S, K).
        snr_db, doppler_hz: (B,).
        freq_matrix: (B, P, K) complex delay→bin matrix of each frame's
            profile; amp: (B, P) path amplitudes.
        time_rank: rank m of the Legendre time prior, or None for full rank.
        f_tables, profile_idx: the packed all-profile tables and each
            frame's profile index. With them the E and D contractions are
            one real matmul each against the static tables followed by a
            per-frame profile select (mmse.py:324-368); without them they
            are per-frame contractions with ``freq_matrix`` (:369-376).

    Returns:
        (B, S, R, T, K) complex, identical along T (the superposition
        observation cannot separate TX antennas). complex64 for complex64
        inputs; complex128 inputs (with float64 ``amp`` and complex128
        ``freq_matrix``, ``f_tables=None``) run the same path in float64,
        the reference that the card's float32 result is held to.
    """
    dev = rx_symbols.device
    real = rx_symbols.real.dtype
    m = pilot_mask.to(real)  # (B, S, K)
    b, s, k = m.shape
    g = masked_ls_grid(rx_symbols, tx_grid, m)  # (B, R, S, K)
    r_rx = g.shape[1]

    n_paths = amp.shape[-1]
    w_path = 0.5 * amp.to(real) ** 2  # (B, P); Jakes E|h|² = ½
    sw = torch.sqrt(w_path)
    t_scale = float(num_tx)

    # Time prior factor V with V·Vᵀ ≈ R_t = J0(2π fd Δs T_sym), ridge scaled
    # to the trace so it stays positive definite in float32.
    fd = torch.as_tensor(doppler_hz, dtype=real, device=dev)
    ds = torch.arange(s, dtype=real, device=dev)
    rt = bessel_j0(
        (2.0 * math.pi * fd)[:, None, None] * (ds[:, None] - ds[None, :]) * symbol_duration
    )  # (B, S, S)
    if time_rank is not None and time_rank < s:
        q = _legendre_basis(s, time_rank, dev).to(real)  # (S, m) static
        bm = q.T @ (rt @ q)  # (B, m, m)
        ridge = 1e-4 * (bm.diagonal(dim1=-2, dim2=-1).sum(-1) / time_rank) + 1e-6
        eye = torch.eye(time_rank, dtype=real, device=dev)
        chol_b = torch.linalg.cholesky(bm + ridge[:, None, None] * eye)
        v = q @ chol_b  # (B, S, m)
    else:
        ridge = 1e-4 * (rt.diagonal(dim1=-2, dim2=-1).sum(-1) / s) + 1e-6
        v = torch.linalg.cholesky(rt + ridge[:, None, None] * torch.eye(s, dtype=real, device=dev))

    f = freq_matrix  # (B, P, K) complex
    if f_tables is not None and profile_idx is not None:
        pidx = torch.as_tensor(profile_idx, device=dev).long()
        rows = torch.arange(b, device=dev)
        c_num, p_num = f_tables.num_profiles, f_tables.num_paths
        g2 = torch.cat([g.real, g.imag], dim=-1)  # (B, R, S, 2K)
        e_all = _split_complex(g2 @ f_tables.w_e).reshape(b, r_rx, s, c_num, p_num)
        e = e_all.permute(0, 3, 1, 2, 4)[rows, pidx]  # (B, R, S, P)
        d_all = _split_complex(m @ f_tables.w_d).reshape(b, s, c_num, p_num, p_num)
        d = d_all.permute(0, 2, 1, 3, 4)[rows, pidx]  # (B, S, P, P)
    else:
        fc = f.conj()
        e = torch.einsum("brsk,bpk->brsp", g, fc)
        a = fc[:, :, None, :] * f[:, None, :, :]  # (B, P, P, K)
        d = torch.einsum("bsk,bpqk->bspq", m.to(g.dtype), a)

    # gram[(p,m),(q,n)] = T·√(w_p w_q)·Σ_s V[s,m]V[s,n]·D[s,p,q]
    mt = v.shape[-1]
    vv = (v[..., :, None] * v[..., None, :]).reshape(b, s, mt * mt)
    dpq = d.reshape(b, s, n_paths * n_paths)
    gmn_pq = vv.transpose(1, 2).to(d.dtype) @ dpq  # (B, MN, PQ)
    gram = gmn_pq.reshape(b, mt, mt, n_paths, n_paths).permute(0, 3, 1, 4, 2)
    gram = t_scale * gram * (sw[:, :, None, None, None] * sw[:, None, None, :, None])
    r_dim = n_paths * mt
    gram = gram.reshape(b, r_dim, r_dim)

    p_ch = w_path.sum(-1)
    snr = torch.as_tensor(snr_db, dtype=real, device=dev)
    snr_lin = 10.0 ** (snr / 10.0)
    sigma2 = (num_tx * p_ch / snr_lin).clamp(min=1e-8)  # (B,)
    gram = gram + sigma2[:, None, None] * torch.eye(r_dim, dtype=gram.dtype, device=dev)

    sqrt_t = math.sqrt(t_scale)
    ph = sqrt_t * torch.einsum("bsm,brsp->brpm", v.to(e.dtype), e) * sw[:, None, :, None]
    rhs = ph.reshape(b, r_rx, r_dim).transpose(1, 2).contiguous()  # (B, r, R)
    z = hpd_solve(gram.contiguous(), rhs)
    sol = z.transpose(1, 2).reshape(b, r_rx, n_paths, mt)  # (B, R, P(q), m(n))

    solw = sol * sw[:, None, :, None]
    sol_sq = torch.einsum("bsn,brqn->brsq", v.to(d.dtype), solw)  # (B, R, S, P)
    corr = sqrt_t * torch.einsum("bspq,brsq->brsp", d, sol_sq)
    t1 = (e - corr) / sigma2[:, None, None, None]  # (B, R, S, P)

    rt_full = v @ v.transpose(1, 2)  # PSD-clamped R_t
    t2 = torch.einsum("bzs,brsp->bzrp", rt_full.to(t1.dtype), t1)
    t2 = t2 * w_path[:, None, None, :]
    h_full = packed_complex_matmul(t2, f)  # (B, S, R, K)
    return h_full[:, :, :, None, :].expand(b, s, r_rx, num_tx, k)
