"""Scattered-pilot selection: the n smallest of each frame's uniforms, ties
broken by linear index, as the pilot mask, the compacted positions and
the validity table of ``physics.pilots.scattered_pattern``.

Replaces no TPU kernel. The JAX package's pattern
(``ce5g_tpu/physics/pilots.py:37-77``) is a ``jnp`` expression that XLA
fuses: 25 rounds of float32 threshold bisection, a cumsum rank and a
scatter. Eager PyTorch runs the same rule as ≈ 228 launches a batch, each
bisection round a full pass over the uniforms with an int64 sum. The
kernel must read the uniforms once and write the mask, the positions and
the validity table once: 8·B·T + 12·B·P bytes, 0.42 GB at 512 frames of
140 × 599 (0.13 ms at 3.35 TB/s), so it is bound by bytes.

On CUDA tensors :func:`pilot_select` launches the kernel of
``csrc/pilot_select.cu``: each frame read once in 16-byte words and kept
in the shared memory of one block (route ``block``) or of a thread block
cluster (``cluster``), or read again from memory in each round where it
is too large for a cluster of 8 (``global``); the 25 rounds count on chip,
one block-wide scan gives the ranks, and one sweep writes every output
element. :func:`plan` lays a launch out from the batch, the frame's size
and the card's SMs. CPU tensors run :func:`pilot_select_plain`, the rule
as the port ran it before the kernel. Both give the same bits: counts and
ranks are integers and every comparison a float32 one.

Each call runs in the span ``ops.pilot_select``; inside it, a launch runs
in the span ``ops.pilot_select.<route>`` and the plain version in
``ops.pilot_select.plain``, each counting the counter of its name
(``_build.run``, ``utils.profiling``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from . import _build

#: the kernel's routes (see the module note)
ROUTES = ("block", "cluster", "global")
#: blocks a frame
CLUSTER_SIZES = (1, 2, 4, 8)
#: bisection rounds of the rule
ROUNDS = 25
#: 16-byte words of a frame one block keeps in shared memory (224 KB of the
#: H100's 227 KB a block)
MAX_WORDS = 14336
#: a frame is cut over more blocks, to give every SM one, only while each
#: block keeps at least this many words
MIN_WORDS = 1024
#: a block takes small frames in turn until it has swept about this many words
BLOCK_WORDS = 2048
#: blocks an SM that a grid of small frames keeps before a block takes several
BLOCKS_PER_SM = 8
MAX_THREADS = 1024


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel selects the pilots of a batch: ``cluster`` blocks a
    frame, each keeping ``words`` 16-byte words of it (in shared memory
    unless the route is ``global``); ``frames`` frames a block, taken in
    turn (cluster 1 only); ``threads`` a block; ``grid`` blocks."""

    route: str
    cluster: int
    frames: int
    words: int
    threads: int
    grid: int


def frame_words(total: int) -> int:
    """The most 16-byte words a frame of ``total`` float32 touches: it may
    start at any 4-byte offset."""
    return (total + 6) // 4


#: the largest frame a cluster keeps on chip
MAX_RESIDENT = 4 * CLUSTER_SIZES[-1] * MAX_WORDS - 3


@functools.lru_cache(maxsize=256)
def plan_for(batch: int, total: int, sms: int) -> Plan:
    """The plan for ``batch`` frames of ``total`` uniforms on a card of
    ``sms`` SMs: the least cluster that keeps a frame on chip, doubled while
    the doubled grid still finds an SM for each block and each block keeps
    ``MIN_WORDS``; past ``MAX_RESIDENT`` the ``global`` route on clusters
    of 8."""
    if batch < 0 or total < 1 or sms < 1:
        raise ValueError(f"no plan for {batch} frames of {total} on {sms} SMs")
    words = frame_words(total)
    cluster = next((c for c in CLUSTER_SIZES if -(-words // c) <= MAX_WORDS), None)
    if cluster is None:
        route, cluster = "global", CLUSTER_SIZES[-1]
    else:
        while (cluster < CLUSTER_SIZES[-1] and 2 * batch * cluster <= sms
               and -(-words // (2 * cluster)) >= MIN_WORDS):
            cluster *= 2
        route = "block" if cluster == 1 else "cluster"
    per = -(-words // cluster)
    # a power of two, at most a quarter of the block's words: a thread counts
    # four words or more each round (within 32 to 1024 threads)
    threads = min(MAX_THREADS, max(32, 1 << (max(per // 4, 1).bit_length() - 1)))
    frames = 1
    if cluster == 1:
        frames = max(1, min(BLOCK_WORDS // per, batch // (BLOCKS_PER_SM * sms)))
    grid = batch * cluster if cluster > 1 else -(-batch // frames)
    return Plan(route, cluster, frames, per, threads, grid)


_SMS = {}  # device index → SMs


def plan(u: torch.Tensor) -> Plan:
    """The plan of this CUDA tensor of uniforms (B, S·K)."""
    index = u.device.index if u.device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return plan_for(u.shape[0], u.shape[1], _SMS[index])


def threshold_select(u: torch.Tensor, n_pilots: torch.Tensor):
    """The plain rule's selection: 25 rounds of float32 threshold bisection
    find each frame's n-th order statistic, then a cumsum rank drops ties
    past n. ``u`` (B, T) float32, ``n_pilots`` (B,) → the kept elements
    (B, T) bool and the rank of each element below the threshold by linear
    index (B, T) int32."""
    b = u.shape[0]
    lo = torch.zeros(b, dtype=torch.float32, device=u.device)
    hi = torch.ones(b, dtype=torch.float32, device=u.device)
    for _ in range(ROUNDS):
        mid = 0.5 * (lo + hi)
        above = (u < mid[:, None]).sum(dim=1) >= n_pilots
        lo, hi = torch.where(above, lo, mid), torch.where(above, mid, hi)
    pre = u < hi[:, None]
    rank = torch.cumsum(pre.to(torch.int32), dim=1) - 1
    return pre & (rank < n_pilots[:, None]), rank


def pilot_select_plain(u: torch.Tensor, n_pilots: torch.Tensor, num_symbols: int,
                       num_subcarriers: int, p_max: int):
    """Plain PyTorch version: :func:`threshold_select`, then the mask, the
    compacted positions and the validity table — the same float32 steps as
    ``ce5g_tpu.physics.pilots.scattered_pattern`` (:37-77). Returns (mask,
    positions, valid)."""
    b, total = u.shape
    dev = u.device
    sel, rank = threshold_select(u, n_pilots)
    mask = sel.reshape(b, num_symbols, num_subcarriers).to(torch.float32)

    # Compact the selected linear indices into the fixed p_max slot table;
    # unselected indices all land in the spare slot p_max, cut off below.
    slots = torch.where(sel, rank, p_max).to(torch.int64)
    lin_idx = torch.arange(total, dtype=torch.int32, device=dev).expand(b, total)
    lin = torch.zeros(b, p_max + 1, dtype=torch.int32, device=dev)
    lin = lin.scatter(1, slots, lin_idx)[:, :p_max]
    positions = torch.stack(
        [lin // num_subcarriers, lin % num_subcarriers], dim=-1
    ).to(torch.int32)
    valid = (
        torch.arange(p_max, device=dev)[None, :] < n_pilots[:, None]
    ).to(torch.float32)
    return mask, positions, valid


_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_vp, _vp, _vp, _vp, _vp, _ll, _ll, _i, _ll, _i, _i, _ll, _i, _i, _vp)


def _check(u: torch.Tensor, n_pilots: torch.Tensor, num_symbols: int, num_subcarriers: int):
    """Raise unless these are uniforms (B, S·K) float32 with no gradient to
    record and (B,) int32 pilot counts on the same device."""
    if u.ndim != 2 or u.shape[1] != num_symbols * num_subcarriers:
        raise ValueError(f"expected uniforms (B, {num_symbols} * {num_subcarriers}), "
                         f"got {tuple(u.shape)}")
    if u.dtype != torch.float32:
        raise TypeError(f"the pilot selection takes float32 uniforms, got {u.dtype}")
    if torch.is_grad_enabled() and u.requires_grad:
        raise TypeError("the pilot selection records no gradient")
    if n_pilots.device != u.device:
        raise ValueError(f"u on {u.device} but n_pilots on {n_pilots.device}")
    if n_pilots.shape != (u.shape[0],) or n_pilots.dtype != torch.int32:
        raise ValueError(f"expected ({u.shape[0]},) int32 pilot counts, got "
                         f"{tuple(n_pilots.shape)} {n_pilots.dtype}")


def pilot_select(u: torch.Tensor, n_pilots: torch.Tensor, num_symbols: int,
                 num_subcarriers: int, p_max: int):
    """The ``n_pilots[b]`` smallest of each frame's uniforms, ties by linear
    index.

    Args:
        u: (B, S·K) float32 uniforms.
        n_pilots: (B,) int32 pilots a frame, on ``u``'s device.
        num_symbols, num_subcarriers: S and K.
        p_max: the slots of the position table.

    Returns:
        mask (B, S, K) float32, 1.0 at the kept elements; positions
        (B, p_max, 2) int32, the (symbol, subcarrier) of the kept elements
        in linear-index order, zero past them; valid (B, p_max) float32,
        1.0 at slots < n.

    Raises:
        TypeError: ``u`` not float32, or it needs a gradient.
        ValueError: a shape that does not match, or the two tensors on
            different devices.
    """
    _check(u, n_pilots, num_symbols, num_subcarriers)
    return _build.run(
        "pilot_select", u.device,
        lambda: pilot_select_plain(u, n_pilots, num_symbols, num_subcarriers, p_max),
        lambda: _launch(plan(u), u, n_pilots, num_symbols, num_subcarriers, p_max))


def _launch(pl: Plan, u: torch.Tensor, n_pilots: torch.Tensor, num_symbols: int,
            num_subcarriers: int, p_max: int):
    """One launch of the kernel by plan ``pl`` on checked CUDA inputs."""
    b, total = u.shape
    u, n_pilots = u.contiguous(), n_pilots.contiguous()
    mask = u.new_empty(b, num_symbols, num_subcarriers)
    positions = n_pilots.new_empty(b, p_max, 2)
    valid = u.new_empty(b, p_max)
    _build.launch(
        "pilot_select", pl.route, u.device, _ARGTYPES, u.data_ptr(), n_pilots.data_ptr(),
        mask.data_ptr(), positions.data_ptr(), valid.data_ptr(), b, total, num_subcarriers,
        p_max, pl.cluster, pl.frames, pl.words, pl.threads, int(pl.route != "global"),
    )
    return mask, positions, valid


def work(batch: int, total: int, p_max: int) -> Tuple[int, int]:
    """(bytes, operations) the selection must move and do: the uniforms
    read once, the mask, positions and validity written once, the pilot
    counts read; 26 float32 comparisons an element (the count at 1, then
    one a round)."""
    nbytes = 8 * batch * total + 12 * batch * p_max + 4 * batch
    return nbytes, (ROUNDS + 1) * batch * total
