"""MIMO channel: frequency response, channel application, AWGN.

Port of ``ce5g_tpu.physics.mimo`` (reference src/channel_simulator.py:263-345),
batched over a leading frame axis B:

  * H[b,s,r,t,k] = Σ_p g[b,s,r,t,p] · F[b,p,k] — one packed real matmul
    against each frame's delay→bin matrix, no FFT;
  * y = H·x per resource element;
  * AWGN scaled to each frame's measured mean received power (:337-343).
    The normal draws are passed in;
  * the time-domain chain's time-varying FIR, y_r(n) = Σ_p Σ_t
    g[n, r, t, p] · x_t(n − d_p), with each frame's own tap delays.

``simulate_batch`` forms H and the received grid through ``ops.channel``,
one kernel call on CUDA; its plain version, on the CPU, is these functions.
"""
from __future__ import annotations

import torch

from ..utils.complexify import packed_complex_matmul


def frequency_response(path_gains, freq_matrix):
    """(B, S, R, T, P) gains × (B, P, K) or (P, K) matrix → (B, S, R, T, K)."""
    return packed_complex_matmul(path_gains, freq_matrix)


def _add_awgn(received, snr_db, noise_re, noise_im):
    """AWGN at each frame's measured mean received power (reference :337-343).

    received: (B, S, R, K) complex; snr_db: (B,); noise_re/noise_im:
    standard normals of the same shape as ``received``.
    """
    signal_power = (received.abs() ** 2).mean(dim=(-3, -2, -1))  # (B,)
    snr = torch.as_tensor(snr_db, dtype=torch.float32, device=received.device)
    snr_linear = 10.0 ** (snr / 10.0)
    noise_std = torch.sqrt(signal_power / snr_linear / 2.0)
    noise = torch.complex(noise_re, noise_im)
    return received + noise * noise_std.reshape(-1, 1, 1, 1)


def apply_channel(tx_symbols, channel_response, snr_db, noise_re, noise_im):
    """y = H·x per RE + AWGN at measured signal power.

    Args:
        tx_symbols: (B, S, T, K) complex.
        channel_response: (B, S, R, T, K) complex.

    Returns:
        (B, S, R, K) complex64 received symbols.
    """
    received = torch.einsum("bsrtk,bstk->bsrk", channel_response, tx_symbols)
    return _add_awgn(received, snr_db, noise_re, noise_im)


def apply_channel_common_grid(tx_grid, path_gains, freq_matrix, snr_db, noise_re, noise_im):
    """y = H·x + AWGN when every TX antenna sends the same grid.

    By linearity y[s,r,k] = ((Σ_t g)[s,r,:] @ F)[k] · x[s,k]: the TX sum
    moves onto the small path-gain tensor before the delay→bin expansion,
    so H is never read again.

    Args:
        tx_grid: (B, S, K) complex — the grid shared by all TX antennas.
        path_gains: (B, S, R, T, P) complex symbol-sampled gains.
        freq_matrix: (B, P, K) or (P, K) delay→bin matrix.
    """
    gsum = path_gains.sum(dim=-2)  # (B, S, R, P)
    hsum = packed_complex_matmul(gsum, freq_matrix)  # (B, S, R, K)
    received = hsum * tx_grid[:, :, None, :]
    return _add_awgn(received, snr_db, noise_re, noise_im)


def time_domain_apply(tx_signal, dense_gains, delay_samples, path_valid):
    """Apply the time-varying FIR channel sample by sample
    (``ce5g_tpu`` mimo.py:113-145), batched over frames whose profiles may
    differ.

    Args:
        tx_signal: (B, T, N) complex serialized signal per TX antenna.
        dense_gains: (B, N, R, T, P) complex per-sample path gains.
        delay_samples: (B, P) int tap delays of each frame's profile.
        path_valid: (B, P) path validity weights.

    Returns:
        (B, R, N) complex64 received signal before noise; x(n − d) is zero
        for n < d, as no input came before the frame.
    """
    b, t, n = tx_signal.shape
    r = dense_gains.shape[2]
    idx = torch.arange(n, device=tx_signal.device)
    y = torch.zeros((b, n, r), dtype=torch.complex64, device=tx_signal.device)
    for p in range(delay_samples.shape[1]):  # ≤ 9 paths
        src = idx[None, :] - delay_samples[:, p:p + 1].long()  # (B, N)
        x_p = torch.gather(tx_signal, 2, src.clamp(min=0)[:, None, :].expand(b, t, n))
        x_p = x_p * (src >= 0)[:, None, :]
        g_p = dense_gains[..., p] * path_valid[:, p].reshape(b, 1, 1, 1)  # (B, N, R, T)
        y += (g_p * x_p.transpose(1, 2)[:, :, None, :]).sum(-1)
    return y.transpose(1, 2)
