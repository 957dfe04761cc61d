"""Blind prior estimation: SNR, Doppler and delay profile from the frame's
own pilots. Port of ``ce5g_tpu.estimators.blind``, batched over a leading
frame axis (the JAX package vmaps one frame).

``mmse_full`` with the simulator's true priors is a bound; a receiver
knows only its pilots and the 3GPP candidate set. Per frame:

  1. the masked LS grid g = m·y/x;
  2. one joint ridge fit of g's pilot values in a delay ⊗ time dictionary,
     h(s, k) ≈ Σ_{d,m} c[d,m]·F_D[d,k]·Q[s,m], F_D over the union of the
     profiles' quantized tap delays (D = 15) and Q an orthonormal Legendre
     basis of rank M (5): one (D·M)×(D·M) Hermitian system with R + 2·D·M
     right-hand sides (the coefficients, G⁻¹G₀ and G⁻¹);
  3. σ̂² from the fit residual over the effective degrees of freedom;
  4. (profile, Doppler) jointly, as the argmin over C·NF candidates of the
     misfit between the measured noise-corrected power and each
     candidate's smeared template |G⁻¹G₀|²·(w_profile ⊗ λ(f_d));
  5. per-tap Wiener prior powers that blend the classified template with
     the smearing-deconvolved empirical powers, gated by each tap's noise
     floor; snr̂ = 10·log10(T·p_ch/σ̂²).

Every contraction is complex64 or float32 at full precision (TF32 is off,
``device.resolve_device``): the JAX package notes that a reduced-precision
gram leaves it non-Hermitian at the 1e-3 level and the Cholesky fails.
Both solves are library calls, as they are XLA solves in the JAX package,
which gives them no Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..physics.profiles import ProfileTable, cached
from .time_prior import legendre_basis, time_correlation

_EPS = 1e-12


class BlindTables(NamedTuple):
    """Static (numpy) tables for blind prior estimation."""

    f_dict: np.ndarray  # (D, K) complex64 — union-delay dictionary responses
    dict_delays: np.ndarray  # (D,) int32
    q_time: np.ndarray  # (S, M) float32 orthonormal Legendre basis
    w_profile: np.ndarray  # (C, D) float32 per-profile tap powers on slots
    p_ch: np.ndarray  # (C,) float32 nominal channel power per profile
    fd_grid: np.ndarray  # (NF,) float32 candidate Dopplers
    fd_lam: np.ndarray  # (NF, M) float32 diag(Qᵀ R_t(f_d) Q) per candidate


class PriorEstimate(NamedTuple):
    """Per-frame estimates, each with a leading frame axis B."""

    profile_idx: torch.Tensor  # (B,) int32
    doppler_hz: torch.Tensor  # (B,) float32
    snr_db: torch.Tensor  # (B,) float32
    sigma2: torch.Tensor  # (B,) float32 — estimated noise variance
    tap_power: torch.Tensor  # (B, D) noise-corrected delay-tap powers (raw)
    order_power: torch.Tensor  # (B, M) noise-corrected time-order powers
    profile_score: torch.Tensor  # (B, C) fit score per profile (higher = better)
    w_tap: torch.Tensor  # (B, D) per-frame Wiener prior tap powers (blended)


def build_blind_tables(cfg, table: ProfileTable, time_rank: int = 5,
                       n_fd: int = 48) -> BlindTables:
    """The static dictionary and template tables for ``cfg``; ``table`` is
    the profile table of the same numerology."""
    s = cfg.ofdm.num_symbols
    valid = table.path_valid > 0
    delays = np.unique(table.delay_samples[valid]).astype(np.int32)  # (D,)
    d = len(delays)

    # F_D[d, k] = exp(-2πj · bin_k · delay_d / N) over the used bins
    phase = -2.0 * np.pi * delays[:, None] * table.used_bins[None, :] / cfg.ofdm.fft_size
    f_dict = np.exp(1j * phase).astype(np.complex64)

    amp = table.amp_overwrite if cfg.channel.tap_collision == "overwrite" else table.amp_accumulate
    w_path = 0.5 * amp.astype(np.float64) ** 2  # (C, P); Jakes E|h|² = ½amp²
    c_num = w_path.shape[0]
    w_profile = np.zeros((c_num, d), np.float32)
    for ci in range(c_num):
        for pi in range(w_path.shape[1]):
            if valid[ci, pi]:
                slot = int(np.searchsorted(delays, table.delay_samples[ci, pi]))
                w_profile[ci, slot] += w_path[ci, pi]
    p_ch = w_profile.sum(axis=1).astype(np.float32)

    q = legendre_basis(s, time_rank)

    fd_max = 1.5 * float(max(cfg.channel.doppler_hz))
    fd_grid = np.geomspace(2.0, max(fd_max, 10.0), n_fd).astype(np.float32)
    rt = time_correlation(torch.from_numpy(fd_grid).double(), s, cfg.ofdm.symbol_duration).numpy()
    lam = np.zeros((n_fd, time_rank), np.float32)
    for i in range(n_fd):
        lam[i] = np.einsum("sm,st,tm->m", q, rt[i], q).astype(np.float32)
    return BlindTables(f_dict, delays, q, w_profile, p_ch, fd_grid, lam)


def blind_tables_for(cfg, table: ProfileTable) -> BlindTables:
    """:func:`build_blind_tables`, once per profile table, tap-collision
    rule and Doppler list."""
    key = ("blind", cfg.channel.tap_collision, tuple(cfg.channel.doppler_hz))
    return cached(table, key, lambda: build_blind_tables(cfg, table))


class DeviceTables(NamedTuple):
    """:class:`BlindTables` as tensors on one device, with the products of
    static tables that every batch would otherwise rebuild."""

    f_dict: torch.Tensor  # (D, K) complex64
    a_re_t: torch.Tensor  # (K, D·D) float32, Re conj(F_d)·F_e
    a_im_t: torch.Tensor  # (K, D·D) float32, Im conj(F_d)·F_e
    q: torch.Tensor  # (S, M) float32
    qq: torch.Tensor  # (S, M·M) float32, q[s,m]·q[s,n]
    cand: torch.Tensor  # (C·NF, D·M) float32, w_profile ⊗ λ(f_d)
    w_profile: torch.Tensor  # (C, D)
    p_ch: torch.Tensor  # (C,)
    fd_grid: torch.Tensor  # (NF,)
    fd_lam: torch.Tensor  # (NF, M)


def device_tables(tables: BlindTables, device) -> DeviceTables:
    """``tables`` on ``device``, with the static products precomputed."""
    f = tables.f_dict
    a = (np.conj(f)[:, None, :] * f[None, :, :]).reshape(-1, f.shape[1])  # (D·D, K)
    q = tables.q_time
    qq = (q[:, :, None] * q[:, None, :]).reshape(q.shape[0], -1)
    cand = (tables.w_profile[:, None, :, None] * tables.fd_lam[None, :, None, :]).reshape(
        -1, f.shape[0] * q.shape[1])

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return DeviceTables(t(f), t(a.real.T.astype(np.float32)),
                        t(a.imag.T.astype(np.float32)), t(q), t(qq), t(cand),
                        t(tables.w_profile), t(tables.p_ch), t(tables.fd_grid),
                        t(tables.fd_lam))


def device_tables_for(cfg, table: ProfileTable, device) -> DeviceTables:
    """:func:`device_tables` of :func:`blind_tables_for`, once per profile
    table, rule, Doppler list and device."""
    key = ("blind", cfg.channel.tap_collision, tuple(cfg.channel.doppler_hz), str(device))
    return cached(table, key, lambda: device_tables(blind_tables_for(cfg, table), device))


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def ridge_solve(gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched complex HPD solve gram⁻¹·rhs by Cholesky (the JAX package's
    ``_hpd_solve_xla``). ``jnp.linalg.cholesky`` symmetrises its input,
    (A + Aᴴ)/2, and so does this: the gram is Hermitian only in exact
    arithmetic. A system that is not positive definite gives NaN, as in
    the JAX package, without a device synchronise."""
    gram = 0.5 * (gram + gram.mH)
    chol, info = torch.linalg.cholesky_ex(gram)
    chol = torch.where((info == 0)[:, None, None], chol, torch.full_like(chol, float("nan")))
    return torch.cholesky_solve(rhs, chol)


def estimate_priors(rx_symbols: torch.Tensor, tx_grid: torch.Tensor, pilot_mask: torch.Tensor,
                    tables: DeviceTables, num_tx: int, ridge_rel: float = 1e-3) -> PriorEstimate:
    """Estimate (profile, Doppler, SNR) of each frame from its pilots.

    Args:
        rx_symbols: (B, S, R, K) complex received grid.
        tx_grid: (B, S, K) complex transmitted grid (common-grid convention).
        pilot_mask: (B, S, K).
        tables: the tables on the frames' device (:func:`device_tables_for`).
        num_tx: TX count (the observed superposition has power T·p_ch).
    """
    dev = rx_symbols.device
    tt = tables
    s_n, m_n = tt.q.shape
    d_n = tt.f_dict.shape[0]
    r_dim = d_n * m_n
    n_fd = tt.fd_grid.shape[0]

    m = pilot_mask.to(torch.float32)  # (B, S, K)
    b_n = m.shape[0]
    g = m[:, None] * (rx_symbols.transpose(1, 2) / (tx_grid + _EPS)[:, None])  # (B, R, S, K)
    r_rx = g.shape[1]

    # e[b,r,s,d] = Σ_k g·F*[d] ;  dmat[b,s,d,d'] = Σ_k m·F*[d]F[d']
    e = g @ tt.f_dict.conj().T  # (B, R, S, D)
    dmat = torch.complex(m @ tt.a_re_t, m @ tt.a_im_t)  # (B, S, D·D)

    # G0[(d,m),(e,n)] = Σ_s q[s,m] q[s,n] dmat[s,d,e]  (Hermitian)
    g0 = tt.qq.T.to(dmat.dtype) @ dmat  # (B, M·M, D·D)
    g0 = g0.reshape(b_n, m_n, m_n, d_n, d_n).permute(0, 3, 1, 4, 2).reshape(b_n, r_dim, r_dim)
    bvec = torch.einsum("sm,brsd->brdm", tt.q.to(e.dtype), e).reshape(b_n, r_rx, r_dim)

    tr_g0 = g0.diagonal(dim1=-2, dim2=-1).real.sum(-1)
    lam = ridge_rel * tr_g0 / r_dim + 1e-6
    gram = g0 + lam[:, None, None] * _eye(r_dim, g0)

    # one factorization, three solves: coefficients, G⁻¹G0 (dof), G⁻¹ (bias)
    eye = _eye(r_dim, g0).expand(b_n, r_dim, r_dim)
    rhs = torch.cat([bvec.transpose(1, 2), g0, eye], dim=2)
    sol = ridge_solve(gram, rhs)
    c = sol[:, :, :r_rx].transpose(1, 2)  # (B, R, r)
    x_dof = sol[:, :, r_rx:r_rx + r_dim]  # G⁻¹G0
    g_inv = sol[:, :, r_rx + r_dim:]

    # σ̂² from effective-dof-corrected residuals, pooled over rx antennas
    total = (g.abs() ** 2).sum(dim=(1, 2, 3))
    g0c = c @ g0.transpose(1, 2)  # (B, R, r): Σ_j g0[i,j] c[r,j]
    fit = 2.0 * (c.conj() * bvec).real.sum(dim=(1, 2)) - (c.conj() * g0c).real.sum(dim=(1, 2))
    resid = (total - fit).clamp(min=0.0)
    n_pilots = m.sum(dim=(1, 2))
    tr_s = torch.minimum(x_dof.diagonal(dim1=-2, dim2=-1).real.sum(-1).clamp(min=0.0),
                         n_pilots - 1.0)
    dof = (r_rx * (n_pilots - tr_s)).clamp(min=1.0)
    sigma2 = (resid / dof).clamp(min=1e-9)  # (B,)

    # noise bias of |c|²: diag of σ²·G⁻¹G0G⁻¹, per rx antenna
    bias = sigma2[:, None] * (x_dof * g_inv.transpose(1, 2)).sum(-1).real  # (B, r)
    power = ((c.abs() ** 2).sum(1) - r_rx * bias).clamp(min=0.0)  # (B, r)

    # joint smearing-aware (profile, Doppler) match against every candidate
    a2 = x_dof.abs() ** 2  # (B, r, r)
    templ = (tt.cand @ a2.transpose(1, 2)) * r_rx  # (B, C·NF, r)
    tp = (templ @ power[:, :, None])[..., 0]  # (B, C·NF)
    t2 = (templ * templ).sum(-1)
    alpha = tp.clamp(min=0.0) / t2.clamp(min=1e-20)
    score_all = (power * power).sum(-1, keepdim=True) - 2.0 * alpha * tp + alpha ** 2 * t2
    best = score_all.argmin(dim=-1)  # (B,)
    profile_idx = torch.div(best, n_fd, rounding_mode="floor")
    fd_idx = best % n_fd
    doppler_hz = tt.fd_grid[fd_idx]
    score = -score_all.reshape(b_n, -1, n_fd).amin(dim=-1)  # (B, C)

    # per-frame Wiener prior tap powers: the classified template blended
    # with the smearing-deconvolved empirical powers (estimators/blind.py
    # in the JAX package explains the tail risk of a hard pick)
    delta = 1e-2 * a2.diagonal(dim1=-2, dim2=-1).sum(-1) / r_dim + 1e-8
    ata = a2.transpose(1, 2) @ a2 + delta[:, None, None] * _eye(r_dim, a2)
    rhs_emp = a2.transpose(1, 2) @ (power / max(r_rx, 1))[:, :, None]
    v_emp = torch.linalg.solve(ata, rhs_emp)[..., 0].clamp(min=0.0).reshape(b_n, d_n, m_n)
    w_emp = v_emp.sum(-1) / s_n  # (B, D)
    lam_best = tt.fd_lam[fd_idx]  # (B, M)
    rows = torch.arange(b_n, device=dev)
    w_cls = (alpha[rows, best][:, None] * tt.w_profile[profile_idx]
             * (lam_best.sum(-1) / s_n)[:, None])
    bias_tap = bias.clamp(min=0.0).reshape(b_n, d_n, m_n).sum(-1) / s_n
    beta = w_emp ** 2 / (w_emp ** 2 + (3.0 * bias_tap) ** 2 + 1e-20)
    w_tap = beta * w_emp + (1.0 - beta) * w_cls
    w_tap = torch.maximum(w_tap, 1e-3 * w_tap.mean(-1, keepdim=True))

    power = power.reshape(b_n, d_n, m_n)
    p_ch = tt.p_ch[profile_idx]
    snr_db = 10.0 * torch.log10((num_tx * p_ch / sigma2).clamp(min=1e-12))
    return PriorEstimate(
        profile_idx=profile_idx.to(torch.int32),
        doppler_hz=doppler_hz,
        snr_db=snr_db,
        sigma2=sigma2,
        tap_power=power.sum(-1),
        order_power=power.sum(-2),
        profile_score=score,
        w_tap=w_tap,
    )
