"""Inputs that stress the two interpolation kernels' designs.

One definition for the CPU tests (JAX package vs plain version), the
card tests (kernel vs plain version) and ``chip_smoke.py``. Everything is
made with numpy from a seed, small (2-4 frames), and returned as CPU
tensors.

Grid form (``interp_fused``): the kernel prunes source rows by their row
distance, lists accepted candidates eight at a time and works tile by
tile on mask bits, so the cases are pilots in one row only (far rows must
be reached while a shell is empty), a single pilot, a regular lattice
(many tied distances: more than eight accepted), a full mask, S = 1 with
K not a multiple of 32, and 1% and 25% density.

Slot form (``interp``): the kernel sorts pilots by subcarrier and gives
every column a window of the same length, so the cases are a column
holding all S symbols' pilots (ties in the stable sort), fewer valid
slots than the 128-candidate window, and fewer slots than 128 altogether.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

GRID_CASES = ("one_row", "single_pilot", "lattice", "full", "s1_k45", "density_1", "density_25")
SLOT_CASES = ("full_column", "few_valid", "few_slots")


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def grid_case(name: str, r: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (B, R, S, K) complex64, zero off-pilot; mask (B, S, K) float32)."""
    rng = np.random.default_rng(GRID_CASES.index(name))
    s, k = 14, 599
    if name == "one_row":
        mask = np.zeros((3, s, k), np.float32)
        mask[0, 0, ::7] = 1
        mask[1, 13, 5::40] = 1
        mask[2, 6, 300:302] = 1
    elif name == "single_pilot":
        mask = np.zeros((3, s, k), np.float32)
        mask[0, 3, 17] = mask[1, 0, 0] = mask[2, 13, 598] = 1
    elif name == "lattice":
        mask = np.zeros((2, s, k), np.float32)
        mask[0, ::4, ::6] = 1
        mask[1, 1::3, 2::5] = 1
    elif name == "full":
        mask = np.ones((2, s, k), np.float32)
    elif name == "s1_k45":
        mask = (rng.random((4, 1, 45)) < 0.2).astype(np.float32)
        mask[3] = 0  # and an empty frame
    elif name in ("density_1", "density_25"):
        density = 0.01 if name == "density_1" else 0.25
        mask = (rng.random((2, s, k)) < density).astype(np.float32)
    else:
        raise ValueError(f"unknown grid case {name!r}")
    b, s, k = mask.shape
    # antennas 0..r-1 of one draw: a case with fewer antennas is a slice of it
    vals = np.ascontiguousarray(_complex(rng, (b, max(r, 4), s, k))[:, :r]) * mask[:, None]
    return torch.from_numpy(vals), torch.from_numpy(mask)


def _slots(rng, s, k, n_valid, p, column=None):
    """n_valid distinct resource elements in row-major order, padded to p
    slots; with ``column``, all s elements of that column are among them."""
    lin = rng.permutation(s * k)
    if column is not None:
        own = np.arange(s) * k + column
        lin = np.concatenate([own, lin[~np.isin(lin, own)]])
    lin = np.sort(lin[:n_valid])
    pos = np.zeros((p, 2), np.int32)
    pos[:n_valid, 0], pos[:n_valid, 1] = lin // k, lin % k
    valid = (np.arange(p) < n_valid).astype(np.float32)
    return pos, valid


def slot_case(name: str, r: int = 2) -> Dict[str, object]:
    """{"values": (B, R, P) complex64 (zero at invalid slots), "positions":
    (B, P, 2) int32, "valid": (B, P) float32, "grid": (S, K)}."""
    rng = np.random.default_rng(100 + SLOT_CASES.index(name))
    if name == "full_column":
        grid, p = (14, 599), 900
        frames = [_slots(rng, *grid, 838, p, column=100),
                  _slots(rng, *grid, 838, p, column=598),
                  _slots(rng, *grid, 300, p, column=0)]
    elif name == "few_valid":
        grid, p = (14, 599), 400
        frames = [_slots(rng, *grid, n, p) for n in (100, 5, 127, 0)]
    elif name == "few_slots":
        grid, p = (6, 100), 90
        frames = [_slots(rng, *grid, n, p) for n in (60, 90)]
    else:
        raise ValueError(f"unknown slot case {name!r}")
    pos = np.stack([f[0] for f in frames])
    valid = np.stack([f[1] for f in frames])
    vals = np.ascontiguousarray(_complex(rng, (len(frames), max(r, 4), p))[:, :r]) * valid[:, None]
    return {"values": torch.from_numpy(vals), "positions": torch.from_numpy(pos),
            "valid": torch.from_numpy(valid), "grid": grid}
