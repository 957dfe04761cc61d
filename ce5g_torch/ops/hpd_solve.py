"""Batched complex Hermitian-positive-definite solve, A·X = B.

Replaces the TPU kernel ``ce5g_tpu/ops/hpd_solve_pallas.py::_kernel``
(launched by ``_hpd_solve_pallas``, wrapped by ``hpd_solve``), which
solves the mmse_full Woodbury system (estimators/mmse.py).

On a CUDA tensor :func:`hpd_solve` launches a hand-written kernel of
``csrc/hpd_solve.cu``; :func:`plan` says which. Every route is an LDLᴴ
elimination of the lower trapezoid of [[A], [Bᴴ]] (the forward
substitution riding on it, no square root), bound on the H100 by the
chain of n dependent steps, not by bytes or operations; the source note
has the designs and ``PERF.md`` the times.

* 'registers' (n ≤ ``MAX_N``): one thread block a system, the trapezoid
  in registers, one barrier a column, then a backward substitution by
  warps with shuffles. The first eight right-hand sides ride the
  elimination, each further one is solved by a warp against the factor
  left in shared memory.
* 'cluster' (n > ``MAX_N``, mmse_full over one LTE radio frame of 140
  symbols: n = 135 at 200 Hz, 171 at 300 Hz): the same elimination over
  ``blocks`` = 1, 2, 4 or 8 blocks a system (1: one block, no cluster;
  else a thread block cluster), the trapezoid in their registers. Each
  column goes into every block's shared memory: one block barrier a
  column in one block; in a cluster, st.async stores counted by an
  mbarrier in each block, the step's arithmetic hiding them. Each block
  keeps a range of rows of the factor for the backward substitution,
  which runs block after block. Eight right-hand sides ride; more are
  chunks of eight, each a cluster of its own.
* 'blocked' (past every cluster instance: n + R > 384): the factor in a
  (B, n, n) device workspace, 32-column panels, then a warp a right-hand
  side through a (B, R, n) one.

On a CPU tensor it runs :func:`hpd_solve_plain`, the same function in
plain PyTorch (Cholesky plus two triangular solves, mirroring the JAX
package's ``_xla_solve``). A system that is not positive definite gives
NaN in both.

Each call runs in the span ``ops.hpd_solve``; inside it, a launch runs in
the span ``ops.hpd_solve.<route>`` and counts the counter of that name,
and on the CPU the plain version runs in ``ops.hpd_solve.plain`` and
counts it (``_build.run``, ``utils.profiling``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import torch

from . import _build

#: the kernel's routes (see the module note)
ROUTES = ("registers", "cluster", "blocked")
#: largest system the register kernel takes: the published matrix in ≤ 140 KB of shared memory
MAX_N = 128
#: right-hand sides that ride the elimination; the kernel takes any number
RIDE_R = 8
_TG = 16  # the threads of a block form a 16 × 16 grid
_PANEL = 32  # the blocked kernel's panel width and tile side
#: blocks a system on the 'cluster' route (1: one block, no cluster)
CLUSTER_SIZES = (1, 2, 4, 8)
#: the cluster kernel's instances (blocks C, row blocks NA, column blocks
#: NB), as ``HPD_CLUSTER_INSTANCES`` in csrc/hpd_solve.cu lists them; one
#: takes n ≤ 16·NB with n + min(R, 8) ≤ 16·C·NA
CLUSTER_INSTANCES = ((1, 9, 9), (1, 10, 10), (2, 6, 11), (2, 7, 14), (4, 4, 16), (8, 3, 20),
                     (8, 3, 24))


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the card solves (B, n, n) systems with R right-hand sides.

    ``route`` is 'registers', 'cluster' or 'blocked' (see the module
    note). ``ride`` right-hand sides are eliminated with the factor; for
    'registers' and 'blocked', ``columns`` lists, per warp of the block,
    the further ones it solves alone. For 'cluster', ``blocks`` blocks
    solve a system (the grid is ``blocks``·B × ``chunks``, a chunk of
    ``ride`` right-hand sides), ``instance`` is the kernel's (blocks, NA,
    NB) and ``rows`` holds, per block, the (first, count) rows of the
    factor it keeps for the backward substitution. ``smem`` is a block's
    shared memory in bytes.
    """

    route: str
    ride: int = 0
    columns: Tuple[Tuple[int, ...], ...] = ()
    smem: int = 0
    blocks: int = 1
    chunks: int = 1
    instance: Tuple[int, int, int] = ()
    rows: Tuple[Tuple[int, int], ...] = ()

    def grid(self, b: int) -> Tuple[int, int]:
        """The launch's grid for ``b`` systems."""
        return (b * self.blocks, self.chunks)


def _first_row(n: int, q: int, c: int) -> int:
    """The first row block ``q`` of ``c`` keeps: the least m with m²·c ≥
    q·n², so that each block keeps about n² / (2c) entries."""
    want = q * n * n
    m = math.isqrt(want // c)
    while m * m * c < want:
        m += 1
    return m


def _instance(n: int, r: int, blocks: int):
    """The least instance of ``blocks`` blocks that takes (n, R), or None."""
    rows = n + min(r, RIDE_R)
    for inst in CLUSTER_INSTANCES:
        c, na, nb = inst
        if c == blocks and n <= _TG * nb and rows <= _TG * c * na:
            return inst
    return None


def _plan(n: int, r: int, blocks: int) -> Plan:
    """The 'cluster' route at ``blocks`` blocks a system; ValueError if
    the kernel has no instance for it."""
    inst = _instance(n, r, blocks)
    if n <= MAX_N or inst is None:
        raise ValueError(f"no cluster instance of {blocks} blocks for n = {n}, R = {r}")
    first = [_first_row(n, q, blocks) for q in range(blocks + 1)]
    rows = tuple((first[q], first[q + 1] - first[q]) for q in range(blocks))
    share = max((hi * (hi - 1) - lo * (lo - 1)) // 2 for lo, hi in zip(first, first[1:]))
    _, na, nb = inst
    # the column buffers (three and their barriers in a cluster), the last
    # block's y'/d, the reciprocal pivots, first rows, flag
    bufs = 2 if blocks == 1 else 3
    static = (bufs * (_TG * blocks * na + 1) * 8 + RIDE_R * _TG * nb * 8 + _TG * nb * 4
              + 4 * (blocks + 1) + 4)
    return Plan("cluster", min(r, RIDE_R), (), 8 * share + static, blocks,
                -(-r // RIDE_R), inst, rows)


def plan(n: int, r: int) -> Plan:
    """The route of an (n, R) solve on the card, as the wrapper launches it."""
    if n > MAX_N:
        for blocks in CLUSTER_SIZES:  # one block where it holds the system, else the least cluster
            if _instance(n, r, blocks) is not None:
                return _plan(n, r, blocks)
        return Plan("blocked", 0, tuple(tuple(range(w, r, RIDE_R)) for w in range(RIDE_R)),
                    2 * _PANEL * (_PANEL + 1) * 8)
    ride = min(r, RIDE_R)
    columns = tuple(tuple(range(RIDE_R + w, r, RIDE_R)) for w in range(RIDE_R))
    return Plan("registers", ride, columns, (n + ride) * (n | 1) * 8)


def hpd_solve_plain(gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (B, n, n), (B, n, R) complex → (B, n, R).
    Systems whose Cholesky fails come back as NaN."""
    chol, info = torch.linalg.cholesky_ex(gram)
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    x = torch.linalg.solve_triangular(chol.mH, y, upper=True)
    bad = (info > 0)[:, None, None]
    return torch.where(bad, torch.full_like(x, float("nan")), x)


_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def hpd_solve(gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """X = A⁻¹B for a batch of HPD systems.

    Args:
        gram: (B, n, n) complex64 Hermitian positive definite.
        rhs: (B, n, R) complex64.

    Returns:
        (B, n, R) complex64; NaN for a system that is not positive definite.
    """
    if gram.ndim != 3 or rhs.ndim != 3 or gram.shape[1] != gram.shape[2] or (
        rhs.shape[:2] != gram.shape[:2]
    ):
        raise ValueError(
            f"expected gram (B, n, n) and rhs (B, n, R), got {tuple(gram.shape)} "
            f"and {tuple(rhs.shape)}"
        )
    if gram.device != rhs.device:
        raise ValueError(f"gram on {gram.device} but rhs on {rhs.device}")
    return _build.run("hpd_solve", gram.device, lambda: hpd_solve_plain(gram, rhs),
                      lambda: _launch(plan(*rhs.shape[1:]), gram, rhs))


def _launch(pl: Plan, gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel ``pl`` names on CUDA tensors."""
    b, n, r = rhs.shape
    if gram.dtype != torch.complex64 or rhs.dtype != torch.complex64:
        raise TypeError(f"hpd_solve kernel takes complex64, got {gram.dtype}, {rhs.dtype}")
    gram, rhs = gram.contiguous(), rhs.contiguous()
    out = torch.empty_like(rhs)
    if b == 0 or r == 0:
        return out
    work_a = work_z = None
    if pl.route == "blocked":
        work_a = torch.empty_like(gram)
        work_z = rhs.new_empty(b, r, n)
    _build.launch(
        "hpd_solve", pl.route, gram.device, _ARGTYPES, gram.data_ptr(), rhs.data_ptr(),
        out.data_ptr(), None if work_a is None else work_a.data_ptr(),
        None if work_z is None else work_z.data_ptr(), b, n, r,
        *(pl.instance if pl.route == "cluster" else (0, 0, 0)),
    )
    return out


def work(b: int, n: int, r: int):
    """(bytes, flops) the solve must move and do: A and B read once, X
    written once; Cholesky n³/6 and two substitutions n²·R/2 each in
    complex multiply-adds of 8 real operations."""
    nbytes = 8 * b * (n * n + 2 * n * r)
    flops = 8 * b * (n ** 3 / 6 + n * n * r)
    return nbytes, flops
