"""Slot-form scattered interpolation: windowed k-NN over sorted pilots.

Replaces the TPU kernel ``ce5g_tpu/ops/interp_pallas.py::_interp_kernel``
(launched by ``interpolate_pallas``). It computes the XLA branch of
``ce5g_tpu.estimators.interpolate.interpolate`` (:129-145), batched over
frames that each have their own pilots:

  * candidates (``_candidate_table``, :79-92): valid pilots sorted by
    subcarrier (stable, so ties keep slot order); each grid column takes
    the C = min(128, P) consecutive sorted pilots starting at
    clip(searchsorted_left(column) − C//2, 0, max(n_valid − C, 0));
  * weights (``_selection_weights``, :47-76): tied shells for 'nearest'
    (k = 1, weight 1) and 'linear' (k = 3, weight 1/(m + 1e-6)); a
    Gaussian exp(−(d² − m)/(4(m + 1))) for 'cubic', m the smallest d²;
    normalised by max(Σw, 1e-12). A frame with no valid slot gives zeros.

The Pallas kernel's 128-column tiles and 384-pilot windows are TPU
tilings; above ≈20% density they make it approximate, while the XLA
branch, and this module, stay exact.

On a CUDA tensor :func:`interpolate_slots` launches the hand-written
kernel in ``csrc/interp.cu``: one block per frame sorts the pilots by
subcarrier in shared memory (a stable counting sort), then a warp takes
16 grid columns at once, two lanes a column and seven symbols a lane, so
that a candidate's coordinates and values are loaded once into registers
and used for seven output points; the Gaussian weight is one multiply-add
and one ``ex2``. On the H100 it is bound by operations (≈17 float
operations per candidate for 'cubic'); the source note has the design
and the numbers. On a CPU tensor it runs :func:`interpolate_slots_plain`,
the same function in plain PyTorch.

That design keeps a frame's R·P values in one block's shared memory, so
:func:`plan` takes it ('frame') only for R ≤ 8 where they fit. Any other
R and P take route 'tile': a first kernel sorts each frame into a device
scratch, and a block per tile of columns stages just the sorted pilots
its columns' windows reach, four antennas at a time. The squared
distances are float32, exact while S² + K² ≤ 2²⁴ (S, K ≤ 4096).

Each call runs in the span ``ops.interp``; inside it, a wrapper call that
launched the kernel (one or two CUDA launches, by route) runs in the span
``ops.interp.<route>`` and the plain version in ``ops.interp.plain``, each
counting the counter of its name (``_build.run``, ``utils.profiling``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from . import _build

_CANDIDATES = 128
_METHODS = ("nearest", "linear", "cubic")
#: most antennas route 'frame' holds
_FRAME_R = 8
#: shared memory a block may use on the H100
_MAX_SMEM = 232448
#: the kernel holds squared distances in float32, exact up to 2^24
_MAX_D2 = 1 << 24
_MAX_SK = 4096
_TILE = 128  # most columns a block of route 'tile' takes
_COLS = 16  # columns a warp takes at once
ROUTES = ("frame", "tile")


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel takes R antennas, P slots on an S × K grid.

    Route 'frame': a block a frame (``tile`` = K, ``tiles`` = 1).
    Route 'tile': ``tiles`` blocks a frame of ``tile`` columns each, each
    staging at most ``cap`` sorted pilots; ``sort_smem`` is the first
    kernel's shared memory. ``rc`` antennas are taken at a time, the last
    chunk padded (``antennas``: the (first, count) chunks); ``smem`` is the
    interpolating block's dynamic shared memory in bytes.
    """

    route: str
    rc: int
    antennas: Tuple[Tuple[int, int], ...]
    tile: int
    tiles: int
    cap: int
    smem: int
    sort_smem: int = 0

    def columns(self, k: int):
        """The (first, count) column range of each block of a frame."""
        return tuple((t * self.tile, min(self.tile, k - t * self.tile))
                     for t in range(self.tiles))


def _frame_smem(r: int, p: int, k: int) -> int:
    """Route 'frame''s block: values, sorted coordinates, keys, sorted
    slots and the column starts and counts (see csrc/interp.cu)."""
    return 8 * r * p + 4 * 4 * p + 4 * (2 * k + 1)


def _check_shape(r: int, p: int, s: int, k: int) -> None:
    if not (r >= 1 and p >= 1 and 1 <= s <= _MAX_SK and 1 <= k <= _MAX_SK
            and s * s + k * k <= _MAX_D2):
        raise ValueError(f"interpolation kernel takes R ≥ 1, P ≥ 1, S, K ≤ {_MAX_SK} and "
                         f"S² + K² ≤ {_MAX_D2}; got R={r}, P={p}, S={s}, K={k}")


def _frame_plan(r: int, p: int, k: int) -> Plan:
    rc = 4 if r % 4 == 0 else 2 if r % 2 == 0 else 1
    return Plan("frame", rc, tuple((c, rc) for c in range(0, r, rc)), k, 1, p,
                _frame_smem(r, p, k))


def _tile_plan(r: int, p: int, s: int, k: int) -> Plan:
    rc = 1 if r == 1 else 2 if r == 2 else 4
    c = min(_CANDIDATES, p)
    per = 8 + 8 * rc  # a staged pilot's coordinates and values
    tile = min(_TILE, k, max(1, (_MAX_SMEM // 2 // per - c) // s + 1))
    if tile > _COLS:
        tile -= tile % _COLS
    cap = min(p, s * (tile - 1) + c)
    cap += cap % 2  # the values start 16-byte aligned
    antennas = tuple((a, min(rc, r - a)) for a in range(0, r, rc))
    return Plan("tile", rc, antennas, tile, -(-k // tile), cap, per * cap, 4 * (2 * k + 1))


def plan(r: int, p: int, s: int, k: int) -> Plan:
    """The launch of R antennas and P slots on an S × K grid: route
    'frame' where R ≤ 8 and the frame fits in a block's 232 448 bytes of
    shared memory, else 'tile', whose tile width T ≤ 128 (a multiple of 16
    where it can be) keeps its window union, min(P, S·(T − 1) + 128)
    sorted pilots of 8 + 8·RC bytes, within half of it (two blocks an SM).
    A tile whose union is longer (two valid slots on one resource element)
    is taken in passes of at most ``cap`` pilots."""
    _check_shape(r, p, s, k)
    fits = r <= _FRAME_R and _frame_smem(r, p, k) <= _MAX_SMEM
    return _plan(r, p, s, k, "frame" if fits else "tile")


def _plan(r: int, p: int, s: int, k: int, route: str) -> Plan:
    return _frame_plan(r, p, k) if route == "frame" else _tile_plan(r, p, s, k)


def _check_method(method: str) -> None:
    if method not in _METHODS:
        raise ValueError(f"Unknown interpolation method: {method!r}")


def candidate_table(positions: torch.Tensor, valid: torch.Tensor, num_subcarriers: int):
    """Sorted-window candidate slots per grid column: (B, K, C) int64, and
    whether each candidate is a valid pilot, (B, K, C) bool."""
    b, p = valid.shape
    c = min(_CANDIDATES, p)
    ok = valid > 0
    sort_key = torch.where(ok, positions[..., 1].to(torch.float32), float("inf"))
    order = torch.argsort(sort_key, dim=-1, stable=True)  # valid first, by subcarrier
    sc_sorted = sort_key.gather(-1, order)
    cols = torch.arange(num_subcarriers, dtype=torch.float32, device=valid.device)
    pos = torch.searchsorted(sc_sorted, cols.expand(b, -1).contiguous())
    n_valid = ok.sum(-1, keepdim=True)
    start = torch.minimum((pos - c // 2).clamp(min=0), (n_valid - c).clamp(min=0))
    cand_sorted = start[..., None] + torch.arange(c, device=valid.device)  # (B, K, C)
    cand = order.gather(-1, cand_sorted.reshape(b, -1)).reshape(cand_sorted.shape)
    return cand, cand_sorted < n_valid[..., None]


def selection_weights(d2: torch.Tensor, method: str) -> torch.Tensor:
    """Normalised per-candidate weights over the last axis of ``d2``
    (+inf where a candidate is absent); rows with no finite candidate get
    all-zero weights."""
    _check_method(method)
    inf = torch.tensor(float("inf"), device=d2.device)
    if method == "cubic":
        mn = d2.amin(dim=-1, keepdim=True)
        mn = torch.where(torch.isfinite(mn), mn, 0.0)
        w = torch.exp(-(d2 - mn) / (4.0 * (mn + 1.0)))
        w = torch.where(torch.isfinite(d2), w, 0.0)
    else:
        remaining = d2
        w = torch.zeros_like(d2)
        for _ in range(1 if method == "nearest" else 3):
            mn = remaining.amin(dim=-1, keepdim=True)
            sel = (remaining <= mn) & torch.isfinite(remaining)  # the tied shell
            w = w + (sel.to(d2.dtype) if method == "nearest" else sel / (mn + 1e-6))
            remaining = torch.where(sel, inf, remaining)
    return w / w.sum(dim=-1, keepdim=True).clamp(min=1e-12)


def slot_weights(positions: torch.Tensor, valid: torch.Tensor,
                 grid_shape: Tuple[int, int], method: str):
    """Candidates (B, K, C) and their weights (B, S, K, C) float32."""
    s, k = grid_shape
    cand, ok = candidate_table(positions, valid, k)
    pos = positions.to(torch.float32)
    b, _, c = cand.shape
    flat = cand.reshape(b, -1)
    cand_sy = pos[..., 0].gather(-1, flat).reshape(b, 1, k, c)
    cand_sc = pos[..., 1].gather(-1, flat).reshape(b, 1, k, c)
    grid_sy = torch.arange(s, dtype=torch.float32, device=valid.device)[:, None, None]
    cols = torch.arange(k, dtype=torch.float32, device=valid.device)[None, :, None]
    d2 = (grid_sy - cand_sy) ** 2 + (cols - cand_sc) ** 2  # (B, S, K, C)
    d2 = torch.where(ok[:, None], d2, float("inf"))
    return cand, selection_weights(d2, method)


def interpolate_slots_plain(pilot_values: torch.Tensor, positions: torch.Tensor,
                            valid: torch.Tensor, grid_shape: Tuple[int, int],
                            method: str = "linear"):
    """Plain PyTorch version: (B, R, P) complex pilot-slot values, (B, P, 2)
    int32 positions and (B, P) float32 valid → (B, R, S, K) complex64."""
    b, r, p = pilot_values.shape
    s, k = grid_shape
    if p == 0:
        return torch.zeros(b, r, s, k, dtype=torch.complex64, device=pilot_values.device)
    cand, w = slot_weights(positions, valid, grid_shape, method)
    idx = cand.reshape(b, 1, -1).expand(b, r, -1)
    v_cand = pilot_values.to(torch.complex64).gather(-1, idx).reshape(b, r, k, -1)

    def apply(plane):
        return torch.einsum("bskc,brkc->brsk", w, plane)

    return torch.complex(apply(v_cand.real), apply(v_cand.imag))


_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 11 + (ctypes.c_void_p,)


def interpolate_slots(pilot_values: torch.Tensor, positions: torch.Tensor,
                      valid: torch.Tensor, grid_shape: Tuple[int, int],
                      method: str = "linear"):
    """Expand pilot-slot values to the full grid.

    Args:
        pilot_values: (B, R, P) complex64 values per (padded) pilot slot.
        positions: (B, P, 2) int32 (symbol, subcarrier) of each slot.
        valid: (B, P) float32 slot validity (1 or 0).
        grid_shape: (S, K).
        method: 'nearest' | 'linear' | 'cubic'.

    Returns:
        (B, R, S, K) complex64.
    """
    _check_method(method)
    b, r, p = pilot_values.shape
    s, k = grid_shape
    if tuple(positions.shape) != (b, p, 2) or tuple(valid.shape) != (b, p):
        raise ValueError(
            f"positions {tuple(positions.shape)} and valid {tuple(valid.shape)} do not "
            f"match values {tuple(pilot_values.shape)}"
        )
    dev = pilot_values.device
    if positions.device != dev or valid.device != dev:
        raise ValueError(
            f"values on {dev}, positions on {positions.device}, valid on {valid.device}"
        )

    def card():
        if pilot_values.dtype != torch.complex64:
            raise TypeError(f"interpolation kernel takes complex64, got {pilot_values.dtype}")
        if p == 0:
            return torch.zeros(b, r, s, k, dtype=torch.complex64, device=dev)
        return _launch(plan(r, p, s, k), pilot_values, positions, valid, grid_shape, method)

    return _build.run("interp", dev, lambda: interpolate_slots_plain(
        pilot_values, positions, valid.to(torch.float32), grid_shape, method), card)


def _launch(pl: Plan, pilot_values, positions, valid, grid_shape, method):
    """Launch the kernel by plan ``pl`` on checked CUDA inputs."""
    b, r, p = pilot_values.shape
    s, k = grid_shape
    dev = pilot_values.device
    _check_shape(r, p, s, k)
    out = torch.empty(b, r, s, k, dtype=torch.complex64, device=dev)
    vals = pilot_values.contiguous()
    pos = positions.to(torch.int32).contiguous()
    ok = valid.to(torch.float32).contiguous()
    order = starts = None
    if pl.route == "tile":
        order = torch.empty(b, p, dtype=torch.int32, device=dev)
        starts = torch.empty(b, k + 1, dtype=torch.int32, device=dev)
    _build.launch(
        "interp", pl.route, dev, _ARGTYPES, vals.data_ptr(), pos.data_ptr(), ok.data_ptr(),
        out.data_ptr(), None if order is None else order.data_ptr(),
        None if starts is None else starts.data_ptr(), b, r, p, s, k, _METHODS.index(method),
        pl.tile, pl.tiles, pl.cap, pl.rc, pl.smem,
    )
    return out


def work(pilot_values: torch.Tensor, positions: torch.Tensor, valid: torch.Tensor,
         grid_shape: Tuple[int, int], method: str):
    """(bytes, flops) the interpolation must move and do on these inputs.

    Bytes: values, positions and valid read once, the output written once.
    Operations, counted from this run's pilots: every output point scores
    the min(C, n_valid) valid candidates of its window. For 'cubic' each
    costs the distance (4), its min, the weight (subtract, scale, exp),
    its sum and 4·R multiply-adds of the re/im planes: 9 + 4·R. For
    'nearest' and 'linear' each costs the distance and 1 or 3 shell
    comparisons, and every point of a frame with pilots applies at least
    one candidate per shell (its weight and 4·R multiply-adds); ties add
    more, so that term is a lower bound.
    """
    b, r, p = pilot_values.shape
    s, k = grid_shape
    nbytes = 8 * b * r * p + 8 * b * p + 4 * b * p + 8 * b * r * s * k
    n_valid = (valid > 0).sum(-1)
    scored = s * k * int(n_valid.clamp(max=min(_CANDIDATES, p)).sum())
    if method == "cubic":
        return nbytes, (9 + 4 * r) * scored
    _check_method(method)
    shells = 1 if method == "nearest" else 3
    applied = s * k * int(n_valid.clamp(max=shells).sum())
    return nbytes, (4 + shells) * scored + (1 + 4 * r) * applied
