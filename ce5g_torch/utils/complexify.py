"""Complex ↔ planar-real conversions (reference: src/utils.py:173-180),
and the packed complex matmul of the thin delay→subcarrier contractions."""
from __future__ import annotations

import torch


def complex_to_real(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Stack (re, im) along ``axis`` (appended last by default)."""
    return torch.stack([x.real, x.imag], dim=axis)


def real_to_complex(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`complex_to_real`."""
    return torch.complex(x.select(axis, 0), x.select(axis, 1))


def packed_complex_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., P) complex × (P, K) complex → (..., K) complex64 as ONE real
    matmul with re/im stacked along the contraction axis:

        [Re(a) Im(a)] @ [[Re(b)  Im(b)]
                         [-Im(b) Re(b)]]  =  [Re(ab) Im(ab)]

    ``b`` may also be batched, (N, P, K), with ``a`` of shape (N, ..., P):
    each leading item of ``a`` is multiplied by its own ``b``.
    """
    k = b.shape[-1]
    a2 = torch.cat([a.real, a.imag], dim=-1)  # (..., 2P)
    top = torch.cat([b.real, b.imag], dim=-1)  # (..., P, 2K)
    bot = torch.cat([-b.imag, b.real], dim=-1)
    w = torch.cat([top, bot], dim=-2)  # (..., 2P, 2K)
    if b.ndim == 2:
        h2 = torch.matmul(a2, w)
    else:
        n = a2.shape[0]
        h2 = torch.matmul(a2.reshape(n, -1, a2.shape[-1]), w)
        h2 = h2.reshape(*a2.shape[:-1], 2 * k)
    return torch.complex(h2[..., :k], h2[..., k:])
