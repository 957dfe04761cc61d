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
   gather is needed (see the JAX module for the derivation). The JAX
   module then forms the pilot-space vector (e − corr)/σ² and projects it
   back; at high SNR that is a difference of nearly equal vectors over a
   small σ², which multiplies float32 rounding by about 1/σ². The port
   solves the same filter by the push-through identity, Ĥ = (V⊗√w)z·F/√T
   with z the HPD solve's solution, which has no such difference. It
   assembles the Woodbury system in float64 and refines the kernel's
   solution once: in float32 the rounding of E and D (whose matmuls' order
   depends on the batch's rows on the card) reached a frame's estimate
   amplified by the system's condition.

The Wiener-prior API (``WienerPrior``, ``build_wiener_prior``,
``wiener_solve``, ``wiener_reconstruct``) is the same filter in its
explicit pilot-axis form for one frame, and ``estimate_covariance`` the
reference's sample covariance (baseline_estimators.py:137-153).
``wiener_solve`` returns the pilot-space vector x = (h − Φ·sol)/σ² itself,
as the JAX package's does, so it keeps that difference: in float32 at
high SNR its x, and ``wiener_reconstruct``'s Ĥ from it, carry rounding of
order eps/σ².

Precision: the entry points pin float32 matmuls to full precision
(``device.resolve_device``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.hpd_solve import hpd_solve
from ..utils.complexify import packed_complex_matmul
from ..utils.profiling import annotate, counters
from .interpolate import interpolate, interpolate_grid
from .ls import ls_at_pilots, masked_ls_grid
from .time_prior import legendre_basis, time_correlation


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


class WienerPrior(NamedTuple):
    """One frame's second-order prior pieces (``ce5g_tpu`` mmse.py:151-157)."""

    phi: torch.Tensor  # (P, r) complex — low-rank pilot factor, weights folded in
    u_scaled: torch.Tensor  # (S, S) real — U·√λ time eigenbasis
    f_mat: torch.Tensor  # (n_paths, K) complex — delay→bin matrix of the profile
    w_path: torch.Tensor  # (n_paths,) path powers ½·amp²


def build_wiener_prior(freq_matrix, amp, doppler_hz, symbol_duration: float,
                       num_symbols: int, positions, valid) -> WienerPrior:
    """The rank-r pilot factor Φ with ΦΦᴴ = R_pp, and the reconstruction
    pieces: Φ[i, (p, m)] = √w_p·F[p, k_i]·(U√λ)[s_i, m], where R_t = UλUᵀ
    with J0 time correlation. The eigenvectors' signs are the library's, so
    Φ and ``u_scaled`` may differ from the JAX package's column by column;
    ΦΦᴴ and U·λ·Uᵀ, and so every result below, do not."""
    w_path = 0.5 * amp.to(torch.float32) ** 2  # Jakes E|h|² = ½
    fd = torch.as_tensor(doppler_hz, dtype=torch.float32, device=amp.device)
    rt = time_correlation(fd, num_symbols, symbol_duration)
    lam, u = torch.linalg.eigh(rt)  # ascending
    u_scaled = u * torch.sqrt(lam.clamp(min=0.0))[None, :]  # (S, S)

    sy, sc = positions[:, 0].long(), positions[:, 1].long()
    f_pil = freq_matrix[:, sc]  # (n_paths, P)
    u_pil = u_scaled[sy]  # (P, S)
    phi = (torch.sqrt(w_path)[:, None] * f_pil).T[:, :, None] * u_pil[:, None, :]
    phi = phi.reshape(phi.shape[0], -1) * valid[:, None]  # (P, n_paths·S)
    return WienerPrior(phi, u_scaled, freq_matrix, w_path)


def wiener_solve(prior: WienerPrior, h_pilots, sigma2, obs_scale):
    """x = (obs_scale·ΦΦᴴ + σ²I)⁻¹ h through the Woodbury identity; h is
    (..., P). The r × r system is Hermitian positive definite, solved by
    ``torch.linalg.cholesky`` and two triangular solves with every leading
    index as one block of right-hand sides, as the JAX package's XLA solve
    (mmse.py:191-212) is: an API call for one frame, not the batched
    ``mmse_full`` path that the HPD kernel serves."""
    phi = prior.phi * obs_scale ** 0.5
    r = phi.shape[1]
    gram = phi.mH @ phi + sigma2 * torch.eye(r, dtype=phi.dtype, device=phi.device)
    ph = torch.einsum("pr,...p->...r", phi.conj(), h_pilots)
    rhs = ph.reshape(-1, r).T  # (r, N)
    chol = torch.linalg.cholesky(gram)
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    z = torch.linalg.solve_triangular(chol.mH, y, upper=True)
    sol = z.T.reshape(ph.shape)
    return (h_pilots - torch.einsum("pr,...r->...p", phi, sol)) / sigma2


def wiener_reconstruct(prior: WienerPrior, x, positions, grid_shape: Tuple[int, int]):
    """Ĥ = R_grid,pilot · x as small matmuls (``ce5g_tpu`` mmse.py:215-230):
    the pilot-axis sum Σ_i x_i·F*[p, k_i]·1[s_i = s] is one one-hot matmul.
    x: (..., P) → (..., S, K)."""
    s, _ = grid_shape
    sy, sc = positions[:, 0].long(), positions[:, 1].long()
    xf = x[..., None, :] * prior.f_mat[:, sc].conj()  # (..., n_paths, P)
    onehot = (sy[:, None] == torch.arange(s, device=sy.device)[None, :]).to(xf.dtype)
    t1 = torch.einsum("...zp,ps->...sz", xf, onehot)  # (..., S, n_paths)
    rt_full = prior.u_scaled @ prior.u_scaled.T  # R_t
    t2 = torch.einsum("zs,...sp->...zp", rt_full.to(t1.dtype), t1) * prior.w_path
    return torch.einsum("...zp,pk->...zk", t2, prior.f_mat)


def estimate_covariance(h_ls):
    """Sample covariance of LS estimates (reference
    baseline_estimators.py:137-153, dead code there, kept for API parity):
    the leading dims flattened, (last_dim, last_dim)."""
    h = h_ls.reshape(-1, h_ls.shape[-1])
    hc = h - h.mean(dim=0, keepdim=True)
    return hc.mH @ hc / max(h.shape[0] - 1, 1)


class FTables(NamedTuple):
    """Packed all-profile delay→bin tables for the E and D contractions."""

    w_e: torch.Tensor  # (2K, 2·C·P) float64
    w_d: torch.Tensor  # (K, 2·C·P·P) float64
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
    )
    a_re = np.einsum("cpk,cqk->kcpq", np.real(ft), np.real(ft)) + np.einsum(
        "cpk,cqk->kcpq", np.imag(ft), np.imag(ft)
    )
    a_im = np.einsum("cpk,cqk->kcpq", np.real(ft), np.imag(ft)) - np.einsum(
        "cpk,cqk->kcpq", np.imag(ft), np.real(ft)
    )
    w_d = np.concatenate([a_re.reshape(k_num, -1), a_im.reshape(k_num, -1)], axis=1)
    return FTables(
        torch.as_tensor(w_e, dtype=torch.float64, device=device),
        torch.as_tensor(w_d, dtype=torch.float64, device=device),
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

    The HPD solve gives z = gram⁻¹·Lᴴe with L = √T·(V⊗√w), gram = σ²I +
    LᴴDL. The JAX package then computes x = (e − DLz)/σ² and Ĥ =
    R_t·x·w·F = (1/T)·L·Lᴴx·F. Since Lᴴx = (Lᴴe − (gram − σ²I)z)/σ² = z
    exactly, the port computes Ĥ = L·z·F/T: the same filter without the
    difference of nearly equal vectors, whose float32 rounding grows as
    1/σ² (tests/test_torch_woodbury.py). E, D, the time prior, gram and
    Lᴴe are computed in float64 (the estimate's rounding of E and D would
    otherwise reach z amplified by gram's condition, and move with the
    batch where a matmul's reduction order does); ``ops.hpd_solve`` solves
    gram rounded to the inputs' precision, and one step of iterative
    refinement with the residual in float64 takes z to float64 accuracy.
    The estimate itself is then rounded only by the final products.

    Returns:
        (B, S, R, T, K) complex, identical along T (the superposition
        observation cannot separate TX antennas). complex64 for complex64
        inputs; complex128 inputs (with float64 ``amp`` and complex128
        ``freq_matrix``, ``f_tables=None``) run the same path in float64,
        the reference that the card's float32 result is held to.

    Spans (``utils.profiling``): ``mmse_full.ls_grid``, ``.time_prior``
    (J0, the Legendre basis, the Cholesky), ``.gram`` (E, D, gram, σ²,
    Lᴴe) and inside it ``.profiles`` (E and D, each frame's own profile
    selected), ``.solve`` (the two HPD solves and the float64 residual),
    ``.reconstruct``. The counter ``mmse_full.profile_tables`` rises by
    the number of profiles contracted at each call with ``f_tables``.
    """
    dev = rx_symbols.device
    out = rx_symbols.dtype  # of the HPD solve and the estimate
    real, wide = torch.float64, torch.complex128  # of the Woodbury system
    with annotate("mmse_full.ls_grid"):
        m = pilot_mask.to(real)  # (B, S, K)
        b, s, k = m.shape
        g = masked_ls_grid(rx_symbols, tx_grid, m).to(wide)  # (B, R, S, K)
    r_rx = g.shape[1]

    n_paths = amp.shape[-1]
    w_path = 0.5 * amp.to(real) ** 2  # (B, P); Jakes E|h|² = ½
    sw = torch.sqrt(w_path)
    t_scale = float(num_tx)

    # Time prior factor V with V·Vᵀ ≈ R_t = J0(2π fd Δs T_sym), ridge scaled
    # to the trace as the JAX package's (which keeps it positive definite in
    # float32).
    with annotate("mmse_full.time_prior"):
        fd = torch.as_tensor(doppler_hz, dtype=real, device=dev)
        rt = time_correlation(fd, s, symbol_duration)  # (B, S, S)
        if time_rank is not None and time_rank < s:
            q = torch.as_tensor(legendre_basis(s, time_rank), device=dev).to(real)  # (S, m)
            bm = q.T @ (rt @ q)  # (B, m, m)
            ridge = 1e-4 * (bm.diagonal(dim1=-2, dim2=-1).sum(-1) / time_rank) + 1e-6
            eye = torch.eye(time_rank, dtype=real, device=dev)
            chol_b = torch.linalg.cholesky(bm + ridge[:, None, None] * eye)
            v = q @ chol_b  # (B, S, m)
        else:
            ridge = 1e-4 * (rt.diagonal(dim1=-2, dim2=-1).sum(-1) / s) + 1e-6
            v = torch.linalg.cholesky(
                rt + ridge[:, None, None] * torch.eye(s, dtype=real, device=dev))

    with annotate("mmse_full.gram"):
        f = freq_matrix.to(wide)  # (B, P, K)
        with annotate("mmse_full.profiles"):
            if f_tables is not None and profile_idx is not None:
                pidx = torch.as_tensor(profile_idx, device=dev).long()
                rows = torch.arange(b, device=dev)
                c_num, p_num = f_tables.num_profiles, f_tables.num_paths
                counters["mmse_full.profile_tables"] += c_num
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
        rhs = ph.reshape(b, r_rx, r_dim).transpose(1, 2)  # (B, r, R)
    # the kernel in the estimate's precision, one step of iterative
    # refinement with the residual in float64
    with annotate("mmse_full.solve"):
        gram_lo = gram.to(out).contiguous()
        z = hpd_solve(gram_lo, rhs.to(out).contiguous()).to(wide)
        z = z + hpd_solve(gram_lo, (rhs - gram @ z).to(out).contiguous()).to(wide)
    sol = z.transpose(1, 2).reshape(b, r_rx, n_paths, mt)  # (B, R, P(q), m(n))

    # Ĥ = L·z·F/T by the push-through identity (see the docstring)
    with annotate("mmse_full.reconstruct"):
        solw = sol * (sw / sqrt_t)[:, None, :, None]
        h_sp = torch.einsum("bsn,brqn->bsrq", v.to(wide), solw)  # (B, S, R, P)
        h_full = packed_complex_matmul(h_sp.to(out), freq_matrix)  # (B, S, R, K)
    return h_full[:, :, :, None, :].expand(b, s, r_rx, num_tx, k)
