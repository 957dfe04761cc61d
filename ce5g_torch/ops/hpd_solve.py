"""Batched complex Hermitian-positive-definite solve, A·X = B.

Replaces the TPU kernel ``ce5g_tpu/ops/hpd_solve_pallas.py::_kernel``
(launched by ``_hpd_solve_pallas``, wrapped by ``hpd_solve``), which
solves the mmse_full Woodbury system (estimators/mmse.py).

On a CUDA tensor :func:`hpd_solve` launches the hand-written kernel in
``csrc/hpd_solve.cu``: one thread block per system, an LDLᴴ elimination
of the lower trapezoid of [[A], [Bᴴ]] held in registers (one barrier a
column, the forward substitution riding on it), then a backward
substitution by warps with shuffles. On the H100 it is bound by the
length of one system's chain of n dependent steps, not by bytes or
operations; the source note has the design and ``PERF.md`` the times. On
a CPU tensor it runs :func:`hpd_solve_plain`, the same function in plain
PyTorch (Cholesky plus two triangular solves, mirroring the JAX
package's ``_xla_solve``). A system that is not positive definite gives
NaN in both.

``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: largest system the kernel takes: the published matrix in ≤ 140 KB of shared memory
MAX_N = 128
#: most right-hand sides the kernel takes
MAX_R = 8

launches = 0


def hpd_solve_plain(gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (B, n, n), (B, n, R) complex → (B, n, R).
    Systems whose Cholesky fails come back as NaN."""
    chol, info = torch.linalg.cholesky_ex(gram)
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    x = torch.linalg.solve_triangular(chol.mH, y, upper=True)
    bad = (info > 0)[:, None, None]
    return torch.where(bad, torch.full_like(x, float("nan")), x)


_launch = None


def _launcher():
    """The C entry point, built and bound on first use."""
    global _launch
    if _launch is None:
        fn = _build.library("hpd_solve").hpd_solve_launch
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i, i, i, vp]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


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
    if gram.device.type == "cpu":
        return hpd_solve_plain(gram, rhs)
    if gram.device.type != "cuda":
        raise ValueError(f"hpd_solve runs on CPU or CUDA tensors, not {gram.device}")
    b, n, r = rhs.shape
    if not (1 <= n <= MAX_N and 1 <= r <= MAX_R):
        raise ValueError(f"hpd_solve kernel takes 1 ≤ n ≤ {MAX_N}, 1 ≤ R ≤ {MAX_R}; got n={n}, R={r}")
    if gram.dtype != torch.complex64 or rhs.dtype != torch.complex64:
        raise TypeError(f"hpd_solve kernel takes complex64, got {gram.dtype}, {rhs.dtype}")
    gram, rhs = gram.contiguous(), rhs.contiguous()
    out = torch.empty_like(rhs)
    if b == 0:
        return out
    status = _launcher()(
        gram.data_ptr(), rhs.data_ptr(), out.data_ptr(), b, n, r,
        torch.cuda.current_stream(gram.device).cuda_stream,
    )
    global launches
    launches += 1
    if status != 0:
        _build.check(_build.library("hpd_solve"), status, "hpd_solve kernel")
    return out


def work(b: int, n: int, r: int):
    """(bytes, flops) the solve must move and do: A and B read once, X
    written once; Cholesky n³/6 and two substitutions n²·R/2 each in
    complex multiply-adds of 8 real operations."""
    nbytes = 8 * b * (n * n + 2 * n * r)
    flops = 8 * b * (n ** 3 / 6 + n * n * r)
    return nbytes, flops
