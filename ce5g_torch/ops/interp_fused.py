"""Fused grid-form scattered interpolation.

Replaces the TPU kernel ``ce5g_tpu/ops/interp_fused_pallas.py::_kernel``
(launched by ``interpolate_grid_fused``). It computes the XLA branch of
``ce5g_tpu.estimators.interpolate.interpolate_grid`` (:264-326): per-row
nearest-pilot fills, a tied-shell k-NN over the 2·S ('nearest') or 4·S
('linear') row candidates, and a normalised weighted mean.

On a CUDA tensor :func:`interpolate_grid_fused` launches the hand-written
kernel in ``csrc/interp_fused.cu``: a block per (frame, tile of ≤ 128
columns) turns the frame's mask into bits, fills the four candidates of
each (row, column) of its tile into shared memory as one 8-byte entry,
and then gives each output point a thread that visits the source rows
outwards from its own and stops where the row distance alone exceeds the
top shell (exact pruning), with integer distances and a branch-free
shell update; accepted candidates are listed and then applied by the
lanes of a warp together. On the H100 it is bound by bytes: values and
mask read once and the output written once, ≥ 44 µs at the main-path
shape; the pruning makes it do less than :func:`work` counts. The source
note has the design and the numbers. On a CPU tensor it runs
:func:`interpolate_grid_plain`, the same function in plain PyTorch.

``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: shared memory a block may use on the H100
_MAX_SMEM = 232448
_MAX_R = 8
_MAX_S = 127
_MAX_K = 32767
_TILE = 128  # most columns a block takes

launches = 0


def _fills(ok: torch.Tensor):
    """Nearest (p1) and second-nearest (p2) pilot column at-or-left and
    at-or-right of each column of ``ok`` (B, S, K) bool; −1 where none."""
    k = ok.shape[-1]
    iota = torch.arange(k, device=ok.device)
    none = torch.full_like(iota, -1)
    p1l = torch.where(ok, iota, none).cummax(dim=-1).values
    rev = torch.where(ok.flip(-1), iota, none).cummax(dim=-1).values
    p1r = torch.where(rev >= 0, k - 1 - rev, none).flip(-1)
    # the pilot before p1l[k] is the nearest at-or-left of column p1l[k] − 1
    prev = torch.cat([torch.full_like(p1l[..., :1], -1), p1l[..., :-1]], dim=-1)
    nxt = torch.cat([p1r[..., 1:], torch.full_like(p1r[..., :1], -1)], dim=-1)
    p2l = torch.where(p1l >= 0, prev.gather(-1, p1l.clamp(min=0)), -1)
    p2r = torch.where(p1r >= 0, nxt.gather(-1, p1r.clamp(min=0)), -1)
    return p1l, p2l, p1r, p2r


def grid_weights(mask: torch.Tensor, method: str):
    """Normalised k-NN weights of the grid interpolation.

    Args:
        mask: (B, S, K) pilot mask.
    Returns:
        w: (B, S_out, C, K) float32 weights over C = n_sides·S candidates,
           ordered (source row, side) as in the JAX package;
        pos: (B, S, n_sides, K) int64 pilot column of each candidate (−1
           where absent).
    """
    b, s, k = mask.shape
    ok = mask > 0
    p1l, p2l, p1r, p2r = _fills(ok)
    cols = torch.arange(k, device=mask.device, dtype=torch.float32)
    inf = torch.tensor(float("inf"), device=mask.device)

    def left(p):
        return torch.where(p >= 0, cols - p, inf)

    def right(p):
        return torch.where(p >= 0, p - cols, inf)

    d_1r = torch.where(p1r == p1l, inf, right(p1r))  # a pilot at k counts once
    if method == "nearest":
        d_sides, p_sides = [left(p1l), d_1r], [p1l, p1r]
    else:
        d_sides = [left(p1l), left(p2l), d_1r, right(p2r)]
        p_sides = [p1l, p2l, p1r, p2r]
    n_sides = len(d_sides)
    d1 = torch.stack(d_sides, dim=-2).reshape(b, n_sides * s, k)
    rows = torch.arange(s, device=mask.device, dtype=torch.float32)
    drow = rows[:, None] - rows.repeat_interleave(n_sides)[None, :]  # (S_out, C)
    d2 = drow[None, :, :, None] ** 2 + d1[:, None, :, :] ** 2  # (B, S_out, C, K)

    fin = torch.isfinite(d2)
    m1 = d2.amin(dim=2, keepdim=True)
    if method == "nearest":
        w = ((d2 <= m1) & fin).to(torch.float32)
    else:
        m2 = torch.where(d2 > m1, d2, inf).amin(dim=2, keepdim=True)
        m3 = torch.where(d2 > m2, d2, inf).amin(dim=2, keepdim=True)
        zero = torch.zeros((), device=mask.device)
        w = torch.where(fin & (d2 <= m1), 1.0 / (m1 + 1e-6), zero)
        w = w + torch.where(fin & (d2 > m1) & (d2 <= m2), 1.0 / (m2 + 1e-6), zero)
        w = w + torch.where(fin & (d2 > m2) & (d2 <= m3), 1.0 / (m3 + 1e-6), zero)
    w = w / w.sum(dim=2, keepdim=True).clamp(min=1e-12)
    return w, torch.stack(p_sides, dim=-2)


def interpolate_grid_plain(value_grid: torch.Tensor, mask: torch.Tensor, method: str):
    """Plain PyTorch version: (B, R, S, K) complex values (zero off-pilot)
    and (B, S, K) mask → (B, R, S, K) complex interpolated grid."""
    b, r, s, k = value_grid.shape
    w, pos = grid_weights(mask, method)
    n_sides = pos.shape[2]
    idx = pos.clamp(min=0)[:, None].expand(b, r, s, n_sides, k)
    src = value_grid[:, :, :, None, :].expand(b, r, s, n_sides, k)

    def apply(plane):
        cand = plane.gather(-1, idx).reshape(b, r, s * n_sides, k)
        return torch.einsum("bsck,brck->brsk", w, cand)

    return torch.complex(apply(src.real), apply(src.imag))


def _smem_bytes(s: int, k: int) -> int:
    """Shared memory of one block of the kernel (see csrc/interp_fused.cu):
    the tile's candidates, the frame's mask bits with four carried pilots
    a word, and 8 listed candidates for each of 256 threads."""
    tiles = -(-k // _TILE)
    return 8 * s * -(-k // tiles) + 20 * s * -(-k // 32) + 4 * 8 * 256


def _lib() -> ctypes.CDLL:
    lib = _build.library("interp_fused")
    fn = lib.interp_fused_launch
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return lib


def interpolate_grid_fused(value_grid: torch.Tensor, mask: torch.Tensor, method: str = "linear"):
    """Interpolate masked pilot values onto the full grid.

    Args:
        value_grid: (B, R, S, K) complex64, zero off-pilot.
        mask: (B, S, K) float pilot mask.
        method: 'nearest' | 'linear'.

    Returns:
        (B, R, S, K) complex64.
    """
    if method not in ("nearest", "linear"):
        raise ValueError(f"grid interpolation supports nearest/linear, got {method!r}")
    b, r, s, k = value_grid.shape
    if tuple(mask.shape) != (b, s, k):
        raise ValueError(
            f"mask {tuple(mask.shape)} does not match values {tuple(value_grid.shape)}"
        )
    if mask.device != value_grid.device:
        raise ValueError(f"mask on {mask.device} but values on {value_grid.device}")
    if value_grid.device.type == "cpu":
        return interpolate_grid_plain(value_grid, mask.to(torch.float32), method)
    if value_grid.device.type != "cuda":
        raise ValueError(f"interpolation runs on CPU or CUDA tensors, not {value_grid.device}")
    if value_grid.dtype != torch.complex64:
        raise TypeError(f"interpolation kernel takes complex64, got {value_grid.dtype}")
    smem = _smem_bytes(s, k)
    if r > _MAX_R or s > _MAX_S or k > _MAX_K or smem > _MAX_SMEM:
        raise ValueError(
            f"interpolation kernel takes R ≤ {_MAX_R}, S ≤ {_MAX_S}, K ≤ {_MAX_K} and "
            f"{smem} ≤ {_MAX_SMEM} bytes of shared memory; got R={r}, S={s}, K={k}"
        )
    vals = value_grid.contiguous()
    m = mask.to(torch.float32).contiguous()
    out = torch.empty_like(vals)
    lib = _lib()
    status = lib.interp_fused_launch(
        m.data_ptr(), vals.data_ptr(), out.data_ptr(), b, r, s, k,
        int(method == "linear"), torch.cuda.current_stream(vals.device).cuda_stream,
    )
    global launches
    launches += 1
    _build.check(lib, status, "interp_fused kernel")
    return out


def work(mask: torch.Tensor, r: int, method: str):
    """(bytes, flops) the interpolation must move and do on these inputs:
    mask and values read once, output written once; ≈ 5 operations per
    candidate distance (S_out·C·K per frame) and 4·R per selected
    candidate (weighted re/im accumulation), counted from this mask."""
    b, s, k = mask.shape
    w, pos = grid_weights(mask, method)
    n_sides = pos.shape[2]
    nbytes = 4 * b * s * k + 2 * 8 * b * r * s * k
    flops = 5 * b * s * (n_sides * s) * k + 4 * r * int((w > 0).sum())
    return nbytes, flops
