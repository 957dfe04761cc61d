"""The channel and the received grid of a batch in one kernel call:
H = Σ_p g·F, each frame's delay→bin matrix F picked by its profile index,
and rx = Σ_t H_t·x_t plus AWGN at each frame's measured mean received
power (``physics.mimo``'s ``frequency_response``, ``apply_channel`` and
``apply_channel_common_grid``).

Replaces no TPU kernel. The JAX package's physics
(``ce5g_tpu/physics/mimo.py:27-110``) is ``jnp`` expressions that XLA
fuses. Eager PyTorch runs them as the packed matmul's real (…, 2K) product,
its complex copy, and about ten passes over the (B, S, R, K) grid for the
received grid and its noise. What the work needs is H written once, the two
noise planes read once and rx written once: 8·BSRTK + 16·BSRK bytes, 9.0 GB
at (64, 14, 64, 4, 3275) and 8.2 GB at (512, 140, 4, 4, 599) (2.69 and 2.46
ms at 3.35 TB/s). On the H100 it is bound by those bytes.

On CUDA tensors :func:`channel` launches the kernel of ``csrc/channel.cu``
(three launches: H and each block's Σ|y|², each frame's noise scale, then
rx): H formed in registers and stored once, never read back; y and its power
taken from the same registers; rx formed again from the gains with the
frame's noise scale, the power summed in float64 in a fixed order so that
two calls give the same bits. The route
is the TX grid's T extent: ``common`` for one grid that every TX antenna
sends, (B, S, 1, K), and ``per_tx`` for one grid each, (B, S, T, K)
(``orthogonal_pilots``). At T = 1 the two are the same sum. :func:`plan`
sizes a launch from the shapes. CPU tensors run :func:`channel_plain`, the
expressions ``physics.simulate_batch`` ran before the kernel.

Each call runs in the span ``ops.channel``; inside it, a launch runs in the
span ``ops.channel.<route>`` and the plain version in ``ops.channel.plain``,
each counting the counter of its name (``_build.run``, ``utils.profiling``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from ..physics import mimo
from . import _build

ROUTES = ("common", "per_tx")
#: profile paths the kernel holds (kMaxPaths): the profile table's MAX_PATHS
MAX_KERNEL_PATHS = 9
#: rows of H a block takes, about
BLOCK_ROWS = 32
#: bytes of gains a block stages in shared memory, at most (kMaxShared)
MAX_STAGED = 48 * 1024
#: threads a block, the widest first
_THREADS = (256, 224, 192, 160, 128)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel takes a batch: ``threads`` a block, ``tiles`` tiles of
    2·threads subcarriers, ``group`` (s, r) rows of one frame a block,
    ``chunks`` groups a frame; ``grid`` blocks, each writing one partial
    (the frames' noise scales follow the partials in the same buffer)."""

    route: str
    threads: int
    tiles: int
    group: int
    chunks: int
    grid: int


@functools.lru_cache(maxsize=256)
def plan_for(b: int, s: int, r: int, t: int, k: int, route: str) -> Plan:
    """The plan for ``b`` frames of S × K at R × T antennas by ``route``:
    the tile width that leaves the fewest idle threads along K (the widest
    where two tie), and ``BLOCK_ROWS`` // T (s, r) rows a block, within the
    frame's S·R and the staging limit."""
    if route not in ROUTES:
        raise ValueError(f"no channel route {route!r}; routes are {ROUTES}")
    if b < 0 or min(s, r, t, k) < 1:
        raise ValueError(f"no channel plan for (B, S, R, T, K) = {(b, s, r, t, k)}")
    pairs = -(-k // 2)
    threads = min(_THREADS, key=lambda n: (-(-pairs // n) * n - pairs, -n))
    tiles = -(-pairs // threads)
    most = MAX_STAGED // (8 * MAX_KERNEL_PATHS * t)
    if most < 1:
        raise ValueError(f"T = {t} TX antennas: one (s, r) row of gains exceeds the channel "
                         f"kernel's {MAX_STAGED} bytes of staging")
    group = max(1, min(BLOCK_ROWS // t, s * r, most))
    chunks = -(-(s * r) // group)
    grid = b * chunks * tiles
    if grid > 2 ** 31 - 1:
        raise ValueError(f"the channel kernel's grid of {grid} blocks is too large")
    return Plan(route, threads, tiles, group, chunks, grid)


def route_of(tx: torch.Tensor) -> str:
    """The route of a TX grid (B, S, 1 or T, K): ``common`` for one grid
    that every TX antenna sends, ``per_tx`` for one each."""
    return "common" if tx.shape[2] == 1 else "per_tx"


def plan(gains: torch.Tensor, tx: torch.Tensor) -> Plan:
    """The plan of these inputs."""
    b, s, r, t, _ = gains.shape
    return plan_for(b, s, r, t, tx.shape[-1], route_of(tx))


def _check(gains, f_table, pidx, tx, snr_db, noise_re, noise_im) -> None:
    """Raise unless the inputs are what the kernel and its plain version take:
    gains (B, S, R, T, P), f_table (C, P, K) and tx (B, S, 1 or T, K)
    complex64; pidx (B,) integer; snr_db (B,) real; noise_re and
    noise_im (B, S, R, K) float32; all on one device."""
    named = {"gains": gains, "f_table": f_table, "pidx": pidx, "tx": tx, "snr_db": snr_db,
             "noise_re": noise_re, "noise_im": noise_im}
    for name, v in named.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(v).__name__}")
    devices = {name: v.device for name, v in named.items()}
    if len(set(devices.values())) != 1:
        raise ValueError(f"the channel's inputs lie on different devices: {devices}")
    for name in ("gains", "f_table", "tx"):
        if named[name].dtype != torch.complex64:
            raise TypeError(f"{name} must be complex64, got {named[name].dtype}")
    for name in ("noise_re", "noise_im"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {named[name].dtype}")
    if pidx.dtype.is_floating_point or pidx.dtype.is_complex or pidx.dtype == torch.bool:
        raise TypeError(f"pidx must be an integer tensor, got {pidx.dtype}")
    if snr_db.dtype.is_complex or snr_db.dtype == torch.bool:
        raise TypeError(f"snr_db must be real, got {snr_db.dtype}")
    if gains.ndim != 5:
        raise ValueError(f"gains must be (B, S, R, T, P), got {tuple(gains.shape)}")
    b, s, r, t, p = gains.shape
    if f_table.ndim != 3 or f_table.shape[1] != p:
        raise ValueError(f"f_table {tuple(f_table.shape)} is not (C, {p}, K)")
    k = f_table.shape[2]
    if tx.ndim != 4 or tuple(tx.shape) not in ((b, s, 1, k), (b, s, t, k)):
        raise ValueError(f"the TX grid {tuple(tx.shape)} is neither {(b, s, 1, k)} nor "
                         f"{(b, s, t, k)}")
    if tuple(pidx.shape) != (b,) or tuple(snr_db.shape) != (b,):
        raise ValueError(f"pidx {tuple(pidx.shape)} and snr_db {tuple(snr_db.shape)} must be "
                         f"({b},)")
    for name in ("noise_re", "noise_im"):
        if tuple(named[name].shape) != (b, s, r, k):
            raise ValueError(f"{name} {tuple(named[name].shape)} is not {(b, s, r, k)}")


def channel_plain(gains, f_table, pidx, tx, snr_db, noise_re, noise_im):
    """Plain PyTorch version: ``mimo.frequency_response`` against each
    frame's matrix ``f_table[pidx]``, then ``mimo.apply_channel_common_grid``
    (route ``common``) or ``mimo.apply_channel`` (``per_tx``). Returns
    (H, rx)."""
    freq_matrix = f_table[pidx]  # (B, P, K)
    h = mimo.frequency_response(gains, freq_matrix)  # (B, S, R, T, K)
    if route_of(tx) == "common":
        # common grid on all TX ⇒ the TX sum moves onto the path gains
        rx = mimo.apply_channel_common_grid(tx[:, :, 0, :], gains, freq_matrix, snr_db,
                                            noise_re, noise_im)
    else:
        rx = mimo.apply_channel(tx, h, snr_db, noise_re, noise_im)
    return h, rx


_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_vp, ctypes.POINTER(_ll), _vp, _ll, _vp, _vp, ctypes.POINTER(_ll), _i, _vp, _vp,
             _vp, _ll, _i, _i, _i, _i, _ll, _i, _i, _i, _vp, _vp, _vp, _vp)


def _launch(pl: Plan, gains, f_table, pidx, tx, snr_db, noise_re, noise_im):
    """Launch the kernel by plan ``pl`` on checked inputs (``f_table``,
    ``noise_re``, ``noise_im`` contiguous, the grid's subcarrier stride 1,
    ``pidx`` int64 and ``snr_db`` float32). Returns (H, rx)."""
    b, s, r, t, p = gains.shape
    c, _, k = f_table.shape
    h = gains.new_empty(b, s, r, t, k)
    rx = gains.new_empty(b, s, r, k)
    partials = noise_re.new_empty(pl.grid + b, dtype=torch.float64)
    gstrides = (_ll * 5)(*gains.stride())
    xstrides = (_ll * 3)(tx.stride(0), tx.stride(1), tx.stride(2))
    _build.launch(
        "channel", pl.route, gains.device, _ARGTYPES, gains.data_ptr(), gstrides,
        f_table.data_ptr(), c, pidx.data_ptr(), tx.data_ptr(), xstrides,
        int(pl.route == "per_tx"), snr_db.data_ptr(), noise_re.data_ptr(), noise_im.data_ptr(),
        b, s, r, t, p, k, pl.threads, pl.tiles, pl.group, partials.data_ptr(), h.data_ptr(),
        rx.data_ptr(),
    )
    return h, rx


def channel(gains: torch.Tensor, f_table: torch.Tensor, pidx: torch.Tensor, tx: torch.Tensor,
            snr_db: torch.Tensor, noise_re: torch.Tensor, noise_im: torch.Tensor):
    """The channel H and the received grid rx of a batch.

    Args:
        gains: (B, S, R, T, P) complex64 symbol-sampled path gains.
        f_table: (C, P, K) complex64 delay→bin matrices, one a profile.
        pidx: (B,) integer profile index of each frame (NaN frames on the
            card for an index outside [0, C)).
        tx: (B, S, 1, K) — one grid for every TX antenna, route ``common`` —
            or (B, S, T, K), route ``per_tx``, complex64.
        snr_db: (B,) SNR in dB.
        noise_re, noise_im: (B, S, R, K) float32 standard normals.

    Returns:
        H (B, S, R, T, K) and rx (B, S, R, K), complex64 and contiguous.

    Raises:
        TypeError, ValueError: inputs of another dtype, shape or device
            (:func:`_check`), or on the card more than ``MAX_KERNEL_PATHS``
            paths.
    """
    _check(gains, f_table, pidx, tx, snr_db, noise_re, noise_im)

    def plain():
        return channel_plain(gains, f_table, pidx, tx, snr_db, noise_re, noise_im)

    def card():
        if gains.shape[-1] > MAX_KERNEL_PATHS:
            raise ValueError(f"the channel kernel takes at most {MAX_KERNEL_PATHS} paths, got "
                             f"{gains.shape[-1]}")
        x = tx if tx.stride(3) == 1 else tx.contiguous()
        return _launch(plan(gains, tx), gains, f_table.contiguous(),
                       pidx.to(torch.int64).contiguous(), x,
                       snr_db.to(torch.float32).contiguous(), noise_re.contiguous(),
                       noise_im.contiguous())

    return _build.run("channel", gains.device, plain, card)


def work(gains: torch.Tensor, tx: torch.Tensor) -> Tuple[int, int]:
    """(bytes, flops) the call must move and do: H written once, the noise
    read once, rx written once and the TX grid's distinct values read once;
    8·P operations an element of H, 2·(T − 1)·P a (symbol, RX) for the TX
    sum of the gains and 8·P + 14 an element of rx (``benchmark/work/
    step.py``'s channel and received-grid lines)."""
    b, s, r, t, p = gains.shape
    k = tx.shape[-1]
    srk = s * r * k
    distinct = math.prod(n for n, st in zip(tx.shape, tx.stride()) if st != 0)
    nbytes = 8 * b * srk * t + 16 * b * srk + 8 * distinct
    flops = b * (8 * p * srk * t + 2 * (t - 1) * p * s * r + (8 * p + 14) * srk)
    return nbytes, flops
