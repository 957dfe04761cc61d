"""The pilot sums of the Wiener MMSE in one kernel call: each frame's E and D
against its own profile's delay→bin matrix, straight from the received grid,

    g[b,r,s,k] = m[b,s,k] · rx[b,s,r,k] / (tx[b,s,k] + 1e-12)
    E[b,r,s,p] = Σ_k g · conj F[c_b,p,k]               (float64 sums)
    D[b,s,p,q] = Σ_k m · conj F[c_b,p,k] · F[c_b,q,k]  (float64, Hermitian)

as ``estimators.mmse.mmse_full_estimate`` takes them (its route with the
profile tables, :class:`FTables`).

Replaces no TPU kernel. The JAX package's masked-grid sums
(``ce5g_tpu/estimators/mmse.py:324-376``) are ``jnp`` expressions that XLA
fuses. Eager PyTorch ran them as the masked LS grid (three dense passes over
(B, R, S, K)), its widening to complex128, a float64 [Re | Im] copy and
float64 products against the tables of every profile, each frame's own then
picked out. What the work needs is the received grid read once, the mask
once, and E and D written once: 1.52 GB at (64, 14, 64, 3275), 0.45 ms at
3.35 TB/s. On the H100 it is bound by those bytes.

On CUDA tensors :func:`profile_gram` launches the kernel of
``csrc/profile_gram.cu`` (one launch): a task a (frame, symbol) row and a
share of its antennas, taken in turn by as many blocks as the card keeps
resident; the task's antennas copied into shared memory whole (cp.async, the
next round or task in flight), the pilots found and staged once, the sums in
float64 registers added in an order that K, P and the row's pilots fix, no
atomics, so that a frame's E and D are the same bits alone and in any batch.
:func:`plan` sizes a launch from the shapes; the route is ``whole`` where a
task takes all R antennas of a row and ``split`` where ``groups`` tasks
share them (D by the first). CPU tensors run :func:`profile_gram_plain`, the
expressions ``mmse_full_estimate`` ran before the kernel: the masked LS grid,
its widening, the products against every profile's tables and the select.

Each call runs in the span ``ops.profile_gram``; inside it, a launch runs in
the span ``ops.profile_gram.<route>`` and the plain version in
``ops.profile_gram.plain``, each counting the counter of its name
(``_build.run``, ``utils.profiling``). ``mmse_full.profile_tables`` rises by
the profile tables each frame is contracted against: 1 a kernel call, C a
plain one.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import counters
from . import _build

ROUTES = ("whole", "split")
#: profile paths the kernel holds (kMaxPaths): the profile table's MAX_PATHS
MAX_KERNEL_PATHS = 9
#: subcarriers a row may have (the kernel keeps pilot indices in 16 bits)
MAX_K = 65535
#: threads a block (kThreads), in warps of 32
THREADS = 256
WARPS = THREADS // 32
#: bytes of received grid a block stages a round, at most, where one
#: antenna's row fits
STAGE_BYTES = 32 * 1024
#: tasks a launch, at least, where a row's antennas can be shared out: many
#: more than the blocks the card keeps resident, which take them in turn
MIN_TASKS = 4096
#: pilots staged at a time, at most
MAX_CHUNK = 512
#: dynamic shared memory a block may have (kMaxShared)
MAX_SHARED = 232448


class FTables(NamedTuple):
    """The profile tables of ``mmse_full_estimate``'s E and D sums: the
    plain version's packed all-profile real tables, and the kernel's copy of
    the delay→bin table laid out a subcarrier at a time."""

    w_e: torch.Tensor  # (2K, 2·C·P) float64
    w_d: torch.Tensor  # (K, 2·C·P·P) float64
    num_profiles: int
    num_paths: int
    freq_kp: torch.Tensor  # (C, K, P) complex64, contiguous


def build_f_tables(f_table: np.ndarray, device) -> FTables:
    """Build the static tables from the (C, P, K) complex delay→bin table of
    every profile (``ce5g_tpu`` mmse.py:339-364):

        e = Σ_k g·conj(F)        → [Re g, Im g] @ w_e
        d = Σ_k m·conj(F_p)·F_q  → m @ w_d

    and the kernel's (C, K, P) copy. They depend only on the profile table:
    build them once per table and device (``estimators.api`` caches them on
    the table).
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
    freq_kp = np.ascontiguousarray(ft.astype(np.complex64).transpose(0, 2, 1))
    return FTables(
        torch.as_tensor(w_e, dtype=torch.float64, device=device),
        torch.as_tensor(w_d, dtype=torch.float64, device=device),
        c_num,
        p_num,
        torch.as_tensor(freq_kp, device=device),
    )


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel takes a batch: ``tasks`` tasks, ``groups`` a (frame,
    symbol) row, each ``rows`` antennas (the last may hold fewer),
    ``round_rows`` of them staged a round, ``strides`` threads a path of an
    antenna's sums, ``chunk`` pilots staged at a time; ``shared`` bytes of
    dynamic shared memory a block."""

    route: str
    groups: int
    rows: int
    round_rows: int
    strides: int
    chunk: int
    shared: int
    tasks: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def shared_bytes(k: int, p: int, round_rows: int, chunk: int) -> int:
    """The kernel's dynamic shared memory (``shared_bytes`` in the source):
    two stage buffers (a round's run and one element of slack, in 16-byte
    words), the divisors, the F values, the mask row, one region for the g
    values of a round and then the threads' partial sums, and the pilot
    indices."""
    stride = (round_rows * k + 2) & ~1
    scratch = _align16(max(8 * round_rows * chunk, 16 * THREADS))
    return (2 * stride * 8 + chunk * 16 + _align16(8 * chunk * p) + _align16(4 * k) + scratch
            + 2 * k)


def sums_of(k: int, p: int) -> Tuple[int, int]:
    """(antennas a round can stage, threads a path of an antenna's sums) at
    K subcarriers and P paths: the most antennas whose rows fit
    ``STAGE_BYTES`` (a power of two, one at least, ``WARPS`` at most) and
    the block's threads shared among their paths. A function of K and P
    alone, so that the order of every sum is too."""
    most = 1
    while 2 * most <= WARPS and 2 * most * k * 8 <= STAGE_BYTES:
        most *= 2
    return most, THREADS // (most * p)


@functools.lru_cache(maxsize=256)
def plan_for(b: int, s: int, r: int, k: int, p: int) -> Plan:
    """The plan for ``b`` frames of S × K at R antennas and P paths: the
    rows' antennas shared out until the launch has ``MIN_TASKS`` tasks (or
    one antenna a task), as many of a task's antennas a round as
    :func:`sums_of` allows (a power of two), and an eighth of a row's
    subcarriers of pilots staged at a time, in whole warps (rows with more
    pilots than that are summed chunk by chunk)."""
    if b < 0 or min(s, r, k, p) < 1:
        raise ValueError(f"no profile_gram plan for (B, S, R, K, P) = {(b, s, r, k, p)}")
    if p > MAX_KERNEL_PATHS or k > MAX_K:
        raise ValueError(f"the profile_gram kernel takes at most {MAX_KERNEL_PATHS} paths and "
                         f"{MAX_K} subcarriers, got P = {p}, K = {k}")
    groups = min(r, max(1, -(-MIN_TASKS // max(b * s, 1))))
    rows = -(-r // groups)
    groups = -(-r // rows)
    most, strides = sums_of(k, p)
    round_rows = 1
    while 2 * round_rows <= min(rows, most):
        round_rows *= 2
    chunk = min(MAX_CHUNK, k, 32 * -(-k // 256))
    shared = shared_bytes(k, p, round_rows, chunk)
    if shared > MAX_SHARED:
        raise ValueError(f"the profile_gram kernel needs {shared} bytes of shared memory at "
                         f"K = {k}, more than {MAX_SHARED}")
    return Plan("split" if groups > 1 else "whole", groups, rows, round_rows, strides, chunk,
                shared, b * s * groups)


def plan(rx: torch.Tensor, tables: FTables) -> Plan:
    """The plan of these inputs."""
    b, s, r, k = rx.shape
    return plan_for(b, s, r, k, tables.num_paths)


def _check(rx, tx, mask, tables, pidx) -> None:
    """Raise unless the shapes are what the kernel and its plain version
    take: rx (B, S, R, K), tx and mask (B, S, K), pidx (B,) integer, the
    tables of K subcarriers, all on one device."""
    named = {"rx": rx, "tx": tx, "mask": mask, "pidx": pidx, "tables.freq_kp": tables.freq_kp}
    for name, v in named.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(v).__name__}")
    devices = {name: v.device for name, v in named.items()}
    if len(set(devices.values())) != 1:
        raise ValueError(f"profile_gram's inputs lie on different devices: {devices}")
    if pidx.dtype.is_floating_point or pidx.dtype.is_complex or pidx.dtype == torch.bool:
        raise TypeError(f"pidx must be an integer tensor, got {pidx.dtype}")
    if rx.ndim != 4:
        raise ValueError(f"rx must be (B, S, R, K), got {tuple(rx.shape)}")
    b, s, _, k = rx.shape
    for name in ("tx", "mask"):
        if tuple(named[name].shape) != (b, s, k):
            raise ValueError(f"{name} {tuple(named[name].shape)} is not {(b, s, k)}")
    if tuple(pidx.shape) != (b,):
        raise ValueError(f"pidx {tuple(pidx.shape)} is not ({b},)")
    want = (tables.num_profiles, k, tables.num_paths)
    if tuple(tables.freq_kp.shape) != want:
        raise ValueError(f"the tables' (C, K, P) {tuple(tables.freq_kp.shape)} is not {want}")


def _check_card(rx, tx, mask, tables) -> None:
    """Raise unless the card's inputs are the kernel's dtypes and contiguous
    (the TX grid, read at the pilots alone, along its subcarriers)."""
    named = {"rx": (rx, torch.complex64), "tx": (tx, torch.complex64),
             "mask": (mask, torch.float32), "tables.freq_kp": (tables.freq_kp, torch.complex64)}
    for name, (v, dtype) in named.items():
        if v.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on the card, got {v.dtype}")
        if not (v.stride(-1) == 1 if name == "tx" else v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on the card")


def _split_complex(x: torch.Tensor) -> torch.Tensor:
    """(..., 2N) real [re | im] → (..., N) complex."""
    re, im = x.chunk(2, dim=-1)
    return torch.complex(re, im)


def profile_gram_plain(rx, tx, mask, tables: FTables, pidx):
    """Plain PyTorch version: the masked LS grid (``estimators.ls``) widened
    to complex128, its float64 [Re | Im] copy against every profile's E
    table and the float64 mask against every D table, each frame's own
    profile then picked out. Returns (E (B, R, S, P), D (B, S, P, P))."""
    # imported here: estimators imports this module
    from ..estimators.ls import masked_ls_grid

    m = mask.to(torch.float64)  # (B, S, K)
    b, s, _ = m.shape
    g = masked_ls_grid(rx, tx, m).to(torch.complex128)  # (B, R, S, K)
    r = g.shape[1]
    rows = torch.arange(b, device=rx.device)
    c_num, p_num = tables.num_profiles, tables.num_paths
    g2 = torch.cat([g.real, g.imag], dim=-1)  # (B, R, S, 2K)
    e_all = _split_complex(g2 @ tables.w_e).reshape(b, r, s, c_num, p_num)
    e = e_all.permute(0, 3, 1, 2, 4)[rows, pidx]  # (B, R, S, P)
    d_all = _split_complex(m @ tables.w_d).reshape(b, s, c_num, p_num, p_num)
    d = d_all.permute(0, 2, 1, 3, 4)[rows, pidx]  # (B, S, P, P)
    return e, d


_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_vp, _vp, _ll, _ll, _vp, _vp, _ll, _vp, _ll, _i, _i, _i, _i, _i, _i, _i, _i, _i,
             _vp, _vp, _vp)


def _launch(pl: Plan, rx, tx, mask, freq_kp, pidx):
    """Launch the kernel by plan ``pl`` on checked inputs (contiguous, the TX
    grid along its subcarriers; ``pidx`` int64). Returns (E, D)."""
    b, s, r, k = rx.shape
    c, _, p = freq_kp.shape
    e = rx.new_empty(b, r, s, p, dtype=torch.complex128)
    d = rx.new_empty(b, s, p, p, dtype=torch.complex128)
    _build.launch(
        "profile_gram", pl.route, rx.device, _ARGTYPES, rx.data_ptr(), tx.data_ptr(),
        tx.stride(0), tx.stride(1), mask.data_ptr(), freq_kp.data_ptr(), c, pidx.data_ptr(), b, s,
        r, p, k, pl.groups, pl.rows, pl.round_rows, pl.strides, pl.chunk, e.data_ptr(),
        d.data_ptr(),
    )
    return e, d


def profile_gram(rx: torch.Tensor, tx: torch.Tensor, mask: torch.Tensor, tables: FTables,
                 pidx: torch.Tensor):
    """Each frame's E and D sums against its own profile.

    Args:
        rx: (B, S, R, K) received grid; tx: (B, S, K) transmitted grid;
            complex64 (the plain version also takes complex128). On the
            card rx is contiguous and tx has a subcarrier stride of 1.
        mask: (B, S, K) float32 pilot mask (0 off the pilots).
        tables: :func:`build_f_tables` of the profile table.
        pidx: (B,) integer profile index of each frame (NaN sums on the card
            for an index outside [0, C)).

    Returns:
        E (B, R, S, P) and D (B, S, P, P), complex128.

    Raises:
        TypeError, ValueError: inputs of another shape or device, or on the
            card of another dtype than complex64 / float32, not contiguous,
            or past the kernel's ``MAX_KERNEL_PATHS`` paths or ``MAX_K``
            subcarriers.
    """
    _check(rx, tx, mask, tables, pidx)

    def plain():
        counters["mmse_full.profile_tables"] += tables.num_profiles
        return profile_gram_plain(rx, tx, mask, tables, pidx)

    def card():
        _check_card(rx, tx, mask, tables)
        pl = plan(rx, tables)
        counters["mmse_full.profile_tables"] += 1
        return _launch(pl, rx, tx, mask, tables.freq_kp, pidx.to(torch.int64).contiguous())

    return _build.run("profile_gram", rx.device, plain, card)


def work(s: int, r: int, k: int, paths: Sequence[int],
         n_pilots: Sequence[int]) -> Tuple[float, float]:
    """(bytes, float64 operations) the call must move and do for frames of
    ``paths`` profile paths and ``n_pilots`` pilots each: the received grid
    and the mask read once, E and D written once; 8·R·n·P operations for E
    and 8·n·P(P + 1)/2 for D (``benchmark/work/profile_gram.py``'s count)."""
    b = len(paths)
    nbytes = b * (8 * r * s * k + 4 * s * k)
    nbytes += sum(16 * r * s * p + 16 * s * p * p for p in paths)
    flops = sum(8 * r * n * p + 8 * n * p * (p + 1) / 2 for p, n in zip(paths, n_pilots))
    return float(nbytes), float(flops)
