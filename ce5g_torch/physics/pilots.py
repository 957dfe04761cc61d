"""Pilot pattern generation, fixed-shape and batched.

Parity source: reference src/channel_simulator.py:206-260, which always
draws *random scattered* pilots (shuffle all S·K resource elements, keep
the first ``int(total·density)``). Port of ``ce5g_tpu.physics.pilots``
with an explicit batch axis; the uniform draws come in as a tensor, so
the same draws give the JAX package's mask and positions exactly.

Fixed-shape contract, per frame:
    mask:      (S, K) float32 — 1.0 at pilot REs;
    positions: (P_max, 2) int32 — (symbol, subcarrier) of each pilot slot;
    valid:     (P_max,) float32 — 1.0 for slots < num_pilots (rest padding).
``P_max = int(total · max_density)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
    then a cumsum rank drops ties past n — the same float32 steps as
    ``ce5g_tpu.physics.pilots.scattered_pattern`` (:37-77), so equal draws
    give an equal pattern.
    """
    b, total = u.shape
    p_max = int(total * max_density)
    dev = u.device
    n_pilots = num_pilots_for(num_symbols, num_subcarriers, density).to(dev)
    n_pilots = n_pilots.expand(b).contiguous()

    lo = torch.zeros(b, dtype=torch.float32, device=dev)
    hi = torch.ones(b, dtype=torch.float32, device=dev)
    for _ in range(25):
        mid = 0.5 * (lo + hi)
        above = (u < mid[:, None]).sum(dim=1) >= n_pilots
        lo, hi = torch.where(above, lo, mid), torch.where(above, mid, hi)
    pre = u < hi[:, None]
    rank = torch.cumsum(pre.to(torch.int32), dim=1) - 1  # rank by linear index
    sel = pre & (rank < n_pilots[:, None])
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
    return PilotPattern(mask, positions, valid, n_pilots)


def make_pattern(
    u: torch.Tensor,
    num_symbols: int,
    num_subcarriers: int,
    density,
    pattern: str = "scattered",
    max_density: float = 0.15,
) -> PilotPattern:
    if pattern in ("comb", "block"):
        raise NotImplementedError(
            f"pilot pattern {pattern!r} is not ported yet (a later slice of "
            "the port); only 'scattered' is"
        )
    if pattern != "scattered":
        raise ValueError(f"Unknown pilot pattern: {pattern!r}")
    # Pilot slots beyond P_max = total·max_density are dropped by the
    # fixed-shape contract; reject a concrete out-of-range density here.
    # A density tensor is not checked: that would stall the device queue.
    if isinstance(density, (int, float)) and density > max_density:
        raise ValueError(
            f"pilot density {density} exceeds max_density {max_density}; "
            "raise max_density to keep the fixed-shape pilot slots exact"
        )
    return scattered_pattern(u, num_symbols, num_subcarriers, density, max_density)
