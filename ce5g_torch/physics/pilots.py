"""Pilot pattern generation, fixed-shape and batched.

Parity source: reference src/channel_simulator.py:206-260, which always
draws *random scattered* pilots (shuffle all S·K resource elements, keep
the first ``int(total·density)``). Port of ``ce5g_tpu.physics.pilots``
with an explicit batch axis; the uniform draws come in as a tensor, so
the same draws give the JAX package's mask and positions exactly. The
regular 'comb' and 'block' patterns of the JAX package draw nothing.

Fixed-shape contract, per frame:
    mask:      (S, K) float32 — 1.0 at pilot REs;
    positions: (P_max, 2) int32 — (symbol, subcarrier) of each pilot slot;
    valid:     (P_max,) float32 — 1.0 for slots < num_pilots (rest padding).
``P_max = int(total · max_density)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.pilot_select import pilot_select


class PilotPattern(NamedTuple):
    mask: torch.Tensor  # (B, S, K) float32
    positions: torch.Tensor  # (B, P_max, 2) int32, padded
    valid: torch.Tensor  # (B, P_max) float32
    num_pilots: torch.Tensor  # (B,) int32


def num_pilots_for(num_symbols: int, num_subcarriers: int, density) -> torch.Tensor:
    """int(total · density) in float32 — reference channel_simulator.py:223-224."""
    total = num_symbols * num_subcarriers
    d = torch.as_tensor(density, dtype=torch.float32)
    return torch.floor(total * d).to(torch.int32)


def scattered_pattern(
    u: torch.Tensor, num_symbols: int, num_subcarriers: int, density, max_density: float = 0.15
) -> PilotPattern:
    """Random scattered pilots from iid uniforms ``u`` of shape (B, S·K).

    Keeps the n smallest uniforms (n = int(S·K·density) per frame): 25
    rounds of float32 threshold bisection find the n-th order statistic,
    then a rank by linear index drops ties past n — the same float32 steps
    as ``ce5g_tpu.physics.pilots.scattered_pattern`` (:37-77), so equal
    draws give an equal pattern. ``ops.pilot_select`` runs the rule: one
    CUDA kernel on the card, its plain PyTorch version on the CPU.
    """
    b, total = u.shape
    p_max = int(total * max_density)
    n_pilots = num_pilots_for(num_symbols, num_subcarriers, density).to(u.device)
    n_pilots = n_pilots.expand(b).contiguous()
    mask, positions, valid = pilot_select(u, n_pilots, num_symbols, num_subcarriers, p_max)
    return PilotPattern(mask, positions, valid, n_pilots)


def _capped(mask: torch.Tensor, p_max: int) -> PilotPattern:
    """The fixed-shape pattern of a (B, S, K) 0/1 mask: pilots in linear
    index order (a stable sort of the mask), at most ``p_max``, and the
    mask cut to the same pilots, so mask consumers (mmse_full and the grid
    form) and position consumers (the slot form) see one pilot set."""
    b, s, k = mask.shape
    flat = mask.reshape(b, s * k)
    flat_idx = torch.argsort(-flat, dim=1, stable=True)[:, :p_max].to(torch.int32)
    count = torch.clamp(flat.sum(dim=1).to(torch.int32), max=p_max)
    positions = torch.stack([flat_idx // k, flat_idx % k], dim=-1)
    valid = (torch.arange(p_max, device=mask.device)[None, :] < count[:, None]).to(torch.float32)
    capped = torch.zeros(b, s * k, dtype=torch.float32, device=mask.device)
    capped = capped.scatter_reduce(1, flat_idx.long(), valid, reduce="amax")
    return PilotPattern(capped.reshape(b, s, k), positions, valid, count)


def comb_pattern(
    u: torch.Tensor, num_symbols: int, num_subcarriers: int, density, max_density: float = 0.15
) -> PilotPattern:
    """Comb pilots (``ce5g_tpu.physics.pilots.comb_pattern``, :80-114):
    every ``step``-th subcarrier on every symbol, step = K // max(n // S, 1)
    for n = int(S·K·density), staggered by step // 2 a symbol. ``u`` only
    gives the batch and device: the pattern draws nothing."""
    b = u.shape[0]
    total = num_symbols * num_subcarriers
    p_max = int(total * max_density)
    dev = u.device
    n_pilots = num_pilots_for(num_symbols, num_subcarriers, density).to(dev).expand(b)
    per_sym = torch.clamp(n_pilots // num_symbols, min=1)
    step = torch.clamp(num_subcarriers // per_sym, min=1)[:, None, None]  # (B, 1, 1)
    s_idx = torch.arange(num_symbols, device=dev)[None, :, None]
    k_idx = torch.arange(num_subcarriers, device=dev)[None, None, :]
    offset = (s_idx * (step // 2)) % step
    mask = (((k_idx - offset) % step) == 0).to(torch.float32)
    return _capped(mask, p_max)


def block_pattern(
    u: torch.Tensor, num_symbols: int, num_subcarriers: int, density, max_density: float = 0.15
) -> PilotPattern:
    """Block pilots (``ce5g_tpu.physics.pilots.block_pattern``, :117-152):
    round(n / K) whole pilot symbols (at least one) at round(i · S / count),
    rounding half to even as ``jnp.round`` does. ``u`` only gives the batch
    and device."""
    b = u.shape[0]
    total = num_symbols * num_subcarriers
    p_max = int(total * max_density)
    dev = u.device
    n_pilots = num_pilots_for(num_symbols, num_subcarriers, density).to(dev).expand(b)
    n_sym_pilot = torch.clamp(torch.round(n_pilots / num_subcarriers).to(torch.int32),
                              1, num_symbols)
    stride = (num_symbols / torch.clamp(n_sym_pilot, min=1))[:, None]  # (B, 1) float32
    rows = torch.arange(num_symbols, device=dev)[None, :]
    sel = torch.round(rows * stride).to(torch.int64).clamp(0, num_symbols - 1)
    take = (rows < n_sym_pilot[:, None]).to(torch.float32)
    is_pilot_sym = torch.zeros(b, num_symbols, dtype=torch.float32, device=dev)
    is_pilot_sym = is_pilot_sym.scatter_reduce(1, sel, take, reduce="amax")
    mask = is_pilot_sym[:, :, None].expand(b, num_symbols, num_subcarriers)
    return _capped(mask, p_max)


_PATTERNS = {
    "scattered": scattered_pattern,
    "comb": comb_pattern,
    "block": block_pattern,
}


def make_pattern(
    u: torch.Tensor,
    num_symbols: int,
    num_subcarriers: int,
    density,
    pattern: str = "scattered",
    max_density: float = 0.15,
) -> PilotPattern:
    """The ``pattern`` pilots of a batch: 'scattered' keeps the smallest of
    the uniforms ``u`` (B, S·K); 'comb' and 'block' are regular and take
    ``u`` for its batch size and device only, as the JAX package's ignore
    their key."""
    try:
        fn = _PATTERNS[pattern]
    except KeyError:
        raise ValueError(f"Unknown pilot pattern: {pattern!r}") from None
    # Pilot slots beyond P_max = total·max_density are dropped by the
    # fixed-shape contract; reject a concrete out-of-range density here.
    # A density tensor is not checked: that would stall the device queue.
    if isinstance(density, (int, float)) and density > max_density:
        raise ValueError(
            f"pilot density {density} exceeds max_density {max_density}; "
            "raise max_density to keep the fixed-shape pilot slots exact"
        )
    return fn(u, num_symbols, num_subcarriers, density, max_density)


def insert_pilots(pattern: PilotPattern, data_symbols, pilot_symbols):
    """A grid with pilots at the mask's REs and data elsewhere (reference
    channel_simulator.py:238-252): both inputs are full (..., S, K) grids
    and the mask selects between them."""
    return torch.where(pattern.mask > 0, pilot_symbols, data_symbols)


def extract_pilots(pattern: PilotPattern, grid):
    """Pilot values in slot order (reference :254-256): (B, ..., P_max)
    from a (B, ..., S, K) grid, zero at invalid slots."""
    sy = pattern.positions[..., 0].long()
    sc = pattern.positions[..., 1].long()
    b = grid.shape[0]
    lead = grid.shape[1:-2]
    flat = grid.reshape(b, -1, grid.shape[-2] * grid.shape[-1])  # (B, M, S·K)
    lin = (sy * grid.shape[-1] + sc)[:, None, :].expand(b, flat.shape[1], -1)
    vals = torch.gather(flat, 2, lin).reshape(b, *lead, -1)
    valid = pattern.valid.reshape(b, *([1] * len(lead)), -1)
    return vals * valid
