"""Sequence-parallel time-domain channel (overlap-save) over the mesh.

Port of ``ce5g_tpu.parallel.time_sharded``. The received signal is
y(t) = Σ_p g_p(t)·x(t − d_p) with tap delays up to 77 samples (ETU at
15.36 MHz). Each rank owns one contiguous block of time; the first
``max_delay`` outputs of block i need the last ``max_delay`` input samples
of block i − 1, the halo. Each rank sends its input tail to its right
neighbour and receives its left neighbour's (``batch_isend_irecv``, the
counterpart of JAX's ``ppermute`` ring); rank 0 takes zeros, the signal's
start. The Jakes gains are evaluated on each block at absolute times, so
the sharded result equals the monolithic one.

The JAX version draws the oscillators from a key on every device; here
they are inputs, as everywhere in the port.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..physics.jakes import jakes_gains_at_times
from ..physics.mimo import time_domain_apply


def _block_apply(x_with_halo, gains, delay_samples, path_valid, halo: int):
    """The time-varying FIR on one block given a left input halo.

    Args:
        x_with_halo: (T, halo + L) input samples, the halo first.
        gains: (L, R, T, P) per-sample gains of the block's own samples.
        delay_samples: (P,) tap delays, each ≤ halo for an exact result
            (a longer one reads from the halo's start, as JAX's clamped
            ``dynamic_slice`` does).
    Returns:
        (R, L) block outputs.
    """
    l = gains.shape[0]
    y = torch.zeros((l, gains.shape[1]), dtype=torch.complex64, device=gains.device)
    for p, d in enumerate(int(v) for v in delay_samples.tolist()):
        start = max(halo - d, 0)
        x_p = x_with_halo[:, start:start + l]  # x(t − d) for t in the block
        g_p = gains[..., p] * path_valid[p]  # (L, R, T)
        y += (g_p * x_p.T[:, None, :]).sum(-1)
    return y.T


def _gains(angles, phases, doppler_hz, amp, times):
    """(L, R, T, P) Jakes gains at ``times`` scaled by the path amplitudes."""
    fd = torch.as_tensor(doppler_hz, dtype=torch.float32, device=angles.device).reshape(1)
    return jakes_gains_at_times(angles[None], phases[None], fd, times)[0] * amp.to(torch.complex64)


def _check_oscillators(angles, num_rx, num_tx):
    if tuple(angles.shape[1:3]) != (num_rx, num_tx):
        raise ValueError(f"oscillators of shape {tuple(angles.shape)} for {num_rx} RX and "
                         f"{num_tx} TX antennas")


def sharded_time_domain_apply(mesh, tx_serial, angles, phases, doppler_hz, amp, delay_samples,
                              path_valid, sampling_rate: float, num_rx: int, num_tx: int,
                              halo: int = 128, axis: str = "data"):
    """Time-sharded fading and FIR over the mesh's ``axis``.

    Args:
        tx_serial: (T, N) serialized transmit signal, the same on every
            rank; N must divide by the axis size.
        angles, phases: (P, R, T, O) oscillators; doppler_hz: scalar;
            amp, delay_samples, path_valid: (P,) of the frame's profile.
        halo: boundary overlap, ≥ the largest delay (77 for ETU).

    Returns:
        (R, N / axis size): this rank's block of the received signal
        before noise.
    """
    _check_oscillators(angles, num_rx, num_tx)
    group = mesh.get_group(axis)
    n_dev, idx = dist.get_world_size(group), mesh.get_local_rank(axis)
    t_ants, n = tx_serial.shape
    if n % n_dev:
        raise ValueError(f"{n} samples do not divide over {n_dev} ranks")
    block = n // n_dev
    if halo > block:
        raise ValueError(f"halo {halo} is longer than a block of {block} samples")
    dev = angles.device
    x_block = tx_serial[:, idx * block:(idx + 1) * block].to(dev)

    # halo exchange: rank i − 1's input tail → rank i; rank 0 keeps zeros
    left = torch.zeros((t_ants, halo, 2), dtype=torch.float32, device=dev)
    ops = []
    if idx + 1 < n_dev:
        tail = torch.view_as_real(x_block[:, -halo:].contiguous())
        ops.append(dist.P2POp(dist.isend, tail, dist.get_global_rank(group, idx + 1), group))
    if idx > 0:
        ops.append(dist.P2POp(dist.irecv, left, dist.get_global_rank(group, idx - 1), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    x_halo = torch.cat([torch.view_as_complex(left), x_block], dim=-1)

    # absolute-time Jakes gains of this block, formed as the JAX package does
    times = (idx * block + torch.arange(block, dtype=torch.float32, device=dev)) / sampling_rate
    gains = _gains(angles, phases, doppler_hz, amp, times)
    return _block_apply(x_halo, gains, delay_samples, path_valid, halo)


def reference_time_domain_apply(tx_serial, angles, phases, doppler_hz, amp, delay_samples,
                                path_valid, sampling_rate: float, num_rx: int, num_tx: int):
    """The monolithic one-device equivalent, (R, N): the gains at every
    sample and ``physics.mimo.time_domain_apply``."""
    _check_oscillators(angles, num_rx, num_tx)
    n = tx_serial.shape[-1]
    times = torch.arange(n, dtype=torch.float32, device=angles.device) / sampling_rate
    gains = _gains(angles, phases, doppler_hz, amp, times)
    return time_domain_apply(tx_serial[None].to(angles.device), gains[None],
                             delay_samples[None], path_valid[None])[0]
