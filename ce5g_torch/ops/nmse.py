"""The score's reduction: Σ|H − Ĥ|² and Σ|H|² in one pass, and the NMSE
(Σ|H − Ĥ|²/N) / (Σ|H|²/N + 1e-12) of ``utils.metrics.nmse``.

Replaces no TPU kernel. The JAX package's score
(``ce5g_tpu/utils/metrics.py:33-38``) is a ``jnp`` expression that XLA
fuses into one pass over H and Ĥ; eager PyTorch splits the same
expression into seven memory-bound passes (a subtraction, two ``abs``,
two squares, two means), each writing its full-size result to device
memory. The estimators return Ĥ broadcast along TX (stride 0), so the
score needs only H read once and Ĥ's distinct values read once:
8·|H| + 8·distinct(Ĥ) bytes, 7.51 GB at (64, 14, 64, 4, 3275) and
0.344 GB at (256, 14, 4, 4, 599). On the H100 it is bound by those bytes
(2.24 and 0.103 ms at 3.35 TB/s).

On CUDA tensors :func:`nmse` launches the kernel of ``csrc/nmse.cu``
(two launches: the pass, then the sum of its partials): it reads each Ĥ
value once and holds it against the T values of H that share it, with
16-byte loads where a row's alignment allows, in a persistent grid, and
adds float32 terms into float64 sums in a fixed order, so that two calls
give the same bits. :func:`plan` lays out the reduction from the tensors'
strides: the reduced axes last (a permutation of strides, no copy),
neighbouring axes merged, the axis along which Ĥ repeats kept apart, and
an inner axis too long for the lines to fill the grid (a contiguous Ĥ, or
one TX antenna) cut into pieces. The kernel takes complex64 with no
gradient to record and Ĥ broadcastable to H's shape on H's card, and
raises on any other CUDA input; CPU tensors run :func:`nmse_plain`, the
expression the score had before.

Each call runs in the span ``ops.nmse``; inside it, a call that launched
the kernel runs in the span ``ops.nmse.<route>`` (``pairs``: unit inner
strides; ``strided``: any other) and the plain expression in
``ops.nmse.plain``, each counting the counter of its name (``_build.run``,
``utils.profiling``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from ..utils import metrics
from . import _build

ROUTES = ("pairs", "strided")
MAX_DIMS = 6  # outer axes the kernel walks (kMaxDims)
_THREADS = 256
_TEAMS = (256, 128, 64, 32)  # threads a line, widest first
_PASSES = 8  # a team passes at least this many times over a row, where it can
_PIECES = 32  # pieces a team where lines are cut into pieces

Dim = Tuple[int, int, int]  # (size, H stride, Ĥ stride), in elements


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel reduces one input. ``rows`` outputs of shape
    ``out_shape``; each the sum over ``lines_per_row`` lines, a line being
    ``rep[0]`` rows of H (stride ``rep[1]``; Ĥ's stride is 0) against one
    row of Ĥ along ``inner``. ``outer`` are the axes that index the lines,
    the kept ones first. A line is taken in ``pieces`` pieces of ``piece``
    elements of ``inner`` (the last shorter). ``team`` threads take a
    piece; the pieces of a row are cut into ``chunks`` work items;
    ``grid`` blocks."""

    route: str
    out_shape: Tuple[int, ...]
    rows: int
    lines_per_row: int
    outer: Tuple[Dim, ...]
    rep: Tuple[int, int]
    inner: Dim
    pieces: int
    piece: int
    team: int
    chunks: int
    grid: int

    @property
    def elements(self) -> int:
        """N, the elements reduced into one output."""
        return self.lines_per_row * self.rep[0] * self.inner[0]

    @property
    def partials(self) -> int:
        """Partial sums the pass writes: one a warp and work item."""
        return self.rows * self.chunks * (self.team // 32)


def _merge(dims) -> list:
    """``dims`` without size-1 axes, neighbours that both tensors lay out
    as one merged."""
    out = []
    for size, hs, es in dims:
        if size == 1:
            continue
        if out and out[-1][1] == size * hs and out[-1][2] == size * es:
            out[-1] = (out[-1][0] * size, hs, es)
        else:
            out.append((size, hs, es))
    return out


def _axes(axes: Optional[Sequence[int]], ndim: int) -> Optional[Tuple[int, ...]]:
    """The reduced axes, sorted and non-negative; None for all (as
    PyTorch's ``mean(dim=())``)."""
    if axes is None:
        return None
    axes = tuple(int(a) for a in axes)
    if not axes:
        return None
    for a in axes:
        if not -ndim <= a < ndim:
            raise IndexError(f"axis {a} out of range for {ndim} dimensions")
    norm = tuple(sorted(a % ndim for a in axes))
    if len(set(norm)) != len(norm):
        raise ValueError(f"axes {axes} name a dimension twice")
    return norm


@functools.lru_cache(maxsize=256)
def plan_for(shape: Tuple[int, ...], h_strides: Tuple[int, ...], e_strides: Tuple[int, ...],
             axes: Optional[Tuple[int, ...]], resident: int) -> Plan:
    """The plan of H and Ĥ (broadcast to H's shape) of these strides over
    the normalised ``axes`` (None: all), on a card that keeps
    ``resident`` blocks at once."""
    red = tuple(range(len(shape))) if axes is None else axes
    kept = [d for d in range(len(shape)) if d not in red]
    out_shape = tuple(shape[d] for d in kept)
    rows = math.prod(out_shape)
    kd = _merge((shape[d], h_strides[d], e_strides[d]) for d in kept) if rows else []
    rd = _merge((shape[d], h_strides[d], e_strides[d]) for d in red)
    if any(size == 0 for size, _, _ in rd):
        rd = [(0, 0, 0)]
    inner = rd.pop() if rd else (1, 0, 0)
    repeats = [i for i, (_, hs, es) in enumerate(rd) if es == 0 and hs != 0]
    rep = (1, 0)
    if repeats:
        i = max(repeats, key=lambda j: (rd[j][0], j))
        rep = rd.pop(i)[:2]
        rd = _merge(rd)
    outer = tuple(kd + rd)
    if len(outer) > MAX_DIMS:
        raise ValueError(f"the NMSE kernel walks at most {MAX_DIMS} outer axes; these strides "
                         f"leave {len(outer)} after merging")
    lines_per_row = math.prod(size for size, _, _ in rd)
    route = "pairs" if inner[1] == 1 and inner[2] == 1 else "strided"
    width = 2 if route == "pairs" else 1  # elements a thread takes at a time
    units = -(-inner[0] // width)
    team = next((t for t in _TEAMS if units >= _PASSES * t), _TEAMS[-1])
    per_block = _THREADS // team
    teams = resident * per_block
    lines = rows * lines_per_row
    piece, pieces = inner[0], 1
    if lines < teams:
        # fewer lines than teams (a contiguous Ĥ, one TX antenna): cut each
        # line into pieces, _PIECES a team, each a whole number of passes
        # of a team (so even on route 'pairs', and every piece keeps its
        # row's 16-byte parity)
        step = team * width
        want = -(-_PIECES * teams // max(lines, 1))
        piece = max(step, inner[0] // want // step * step)
        pieces = max(1, -(-inner[0] // piece))
    # no more work items than teams (unless the rows alone are more), so
    # that no team takes two where others take one
    chunks = max(1, min(lines_per_row * pieces, teams // max(rows, 1)))
    grid = max(1, min(resident, -(-rows * chunks // per_block)))
    return Plan(route, out_shape, rows, lines_per_row, outer, rep, inner, pieces, piece, team,
                chunks, grid)


_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ((_vp, _vp, ctypes.POINTER(_ll)) + (_ll,) * 10
             + (_i, _i, _i, ctypes.c_double, _vp, _vp, _vp, _vp))
_RESIDENT = {}  # device index → resident blocks


def _resident(device: torch.device) -> int:
    """Blocks of the pass the card keeps resident at once (all SMs)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _RESIDENT:
        n = ctypes.c_int(0)
        _build.call("nmse", "nmse_resident_blocks", (_i, ctypes.POINTER(_i)), index,
                    ctypes.byref(n))
        _RESIDENT[index] = n.value
    return _RESIDENT[index]


def plan(h_true: torch.Tensor, h_est: torch.Tensor, axes: Optional[Sequence[int]] = None) -> Plan:
    """The plan of these CUDA tensors (``h_est`` broadcast to ``h_true``'s
    shape)."""
    e = h_est.expand(h_true.shape)
    return plan_for(tuple(h_true.shape), h_true.stride(), e.stride(),
                    _axes(axes, h_true.ndim), _resident(h_true.device))


def _check(h_true: torch.Tensor, h_est: torch.Tensor) -> None:
    """Raise unless the kernel takes these CUDA inputs: complex64, no
    gradient to record, Ĥ broadcastable to H's shape."""
    if h_true.dtype != torch.complex64 or h_est.dtype != torch.complex64:
        raise TypeError(f"the NMSE kernel takes complex64, got {h_true.dtype}, {h_est.dtype}")
    if torch.is_grad_enabled() and (h_true.requires_grad or h_est.requires_grad):
        raise TypeError("the NMSE kernel records no gradient")
    if h_est.ndim > h_true.ndim or any(
            e not in (1, h) for e, h in zip(reversed(h_est.shape), reversed(h_true.shape))):
        raise ValueError(f"h_est {tuple(h_est.shape)} does not broadcast to h_true "
                         f"{tuple(h_true.shape)}")


def nmse_plain(h_true, h_est, axes: Optional[Sequence[int]] = None):
    """Plain PyTorch version: ``utils.metrics.mse`` / mean|H_true|²
    (reference: src/utils.py:166-170), float32 reductions."""
    pwr = h_true.abs() ** 2
    p = pwr.mean() if axes is None else pwr.mean(dim=tuple(axes))
    return metrics.mse(h_true, h_est, axes) / (p + metrics.EPS)


def _launch(pl: Plan, h_true: torch.Tensor, h_est: torch.Tensor):
    """Launch the kernel by plan ``pl`` on checked CUDA inputs (``h_est``
    of ``h_true``'s shape). Returns the float32 NMSE and the float64 sums
    (..., 2): Σ|H − Ĥ|², Σ|H|²."""
    dev = h_true.device
    partials = torch.empty(max(pl.partials, 1), 2, dtype=torch.float64, device=dev)
    sums = torch.empty(pl.rows, 2, dtype=torch.float64, device=dev)
    out = torch.empty(pl.rows, dtype=torch.float32, device=dev)
    pad = [(1, 0, 0)] * (MAX_DIMS - len(pl.outer)) + list(pl.outer)
    outer = (ctypes.c_longlong * (3 * MAX_DIMS))(*(d[j] for j in range(3) for d in pad))
    _build.launch(
        "nmse", pl.route, dev, _ARGTYPES, h_true.data_ptr(), h_est.data_ptr(), outer,
        pl.rep[0], pl.rep[1], *pl.inner, pl.rows, pl.lines_per_row, pl.pieces, pl.piece,
        pl.chunks, pl.team, pl.grid, int(pl.route == "pairs"), metrics.EPS,
        partials.data_ptr(), sums.data_ptr(), out.data_ptr(),
    )
    return out.reshape(pl.out_shape), sums.reshape(pl.out_shape + (2,))


def _reduce(h_true: torch.Tensor, h_est: torch.Tensor, axes, with_mse: bool):
    """The NMSE over ``axes`` and, ``with_mse``, the MSE (else None), in
    the span ``ops.nmse``: the plain expression on the CPU, one kernel
    call on CUDA."""
    if h_est.device != h_true.device:
        raise ValueError(f"h_true on {h_true.device} but h_est on {h_est.device}")

    def plain():
        m = metrics.mse(h_true, h_est, axes) if with_mse else None
        return nmse_plain(h_true, h_est, axes), m

    def card():
        _check(h_true, h_est)
        e = h_est.expand(h_true.shape)
        pl = plan(h_true, e, axes)
        out, sums = _launch(pl, h_true, e)
        return out, (sums[..., 0] / pl.elements).float() if with_mse else None

    return _build.run("nmse", h_true.device, plain, card)


def nmse(h_true: torch.Tensor, h_est: torch.Tensor, axes: Optional[Sequence[int]] = None):
    """(Σ|H − Ĥ|²/N) / (Σ|H|²/N + 1e-12) over ``axes`` (None: all).

    Args:
        h_true: the channel H.
        h_est: the estimate Ĥ, broadcastable to H.
        axes: the reduced axes, as ``Tensor.mean``'s ``dim``.

    Returns:
        float32 NMSE of the shape that remains (0-d for all axes).

    Raises:
        TypeError: on CUDA, an input that is not complex64 or needs a
            gradient.
        ValueError: tensors on different devices, or on CUDA an ``h_est``
            that does not broadcast to ``h_true``'s shape.
    """
    return _reduce(h_true, h_est, axes, False)[0]


def mse_nmse(h_true: torch.Tensor, h_est: torch.Tensor):
    """(MSE, NMSE) over every axis, float32, from the one reduction of
    :func:`nmse` (``utils.metrics.evaluate_estimator``'s pair)."""
    out, m = _reduce(h_true, h_est, None, True)
    return m, out


def work(h_true: torch.Tensor, h_est: torch.Tensor):
    """(bytes, flops) the score must move and do: H read once and Ĥ's
    distinct values (its broadcast axes left out) read once; 10 operations
    an element of H (the difference, two |·|² and two sums)."""
    e = h_est.expand(h_true.shape)
    distinct = math.prod(size for size, st in zip(e.shape, e.stride()) if st != 0)
    return 8 * h_true.numel() + 8 * distinct, 10 * h_true.numel()
