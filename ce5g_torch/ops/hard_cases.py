"""Inputs that stress the three kernels' designs.

One definition for the CPU tests (JAX package vs plain version), the
card tests (kernel vs plain version) and ``chip_smoke.py``. Everything is
made with numpy from a seed, small (2-4 frames), and returned as CPU
tensors.

Grid form (``interp_fused``): the kernel prunes source rows by their row
distance, lists accepted candidates eight at a time and works tile by
tile on mask bits, so the cases are pilots in one row only (far rows must
be reached while a shell is empty), a single pilot, a regular lattice
(many tied distances: more than eight accepted), a full mask, S = 1 with
K not a multiple of 32, 1% and 25% density, and the regular patterns of
``physics.pilots``: comb (a lattice staggered by symbol; at 15% cut to
the pilot-slot capacity mid-row) and block (whole pilot rows: one or two
of the 14).

Slot form (``interp``): the kernel sorts pilots by subcarrier and gives
every column a window of the same length, so the cases are a column
holding all S symbols' pilots (ties in the stable sort), fewer valid
slots than the 128-candidate window, fewer slots than 128 altogether,
and comb and block pilots (a block column holds one or two pilots, its
row all 599).

HPD solve (``hpd_solve``): the kernel lays a grid of 16 × 16 threads
over the matrix in blocks, so the cases are n = 1 and 2, n at and around
multiples of 8 and 16 where an instance changes (and 31-33, 63-65 where
the lanes' entry count does), n = 128, R = 1, 3 and 8, one system and an
odd count, condition number 1e4, and systems that are not positive
definite: first, middle and last of a batch, one with a NaN entry, one
whose pivot turns negative only at the last column. The widest instance
(n = 113-128, all eight column blocks and the ninth row block in use)
has four more cases with R = 8 and seeds of their own, three of them a
single system.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

GRID_CASES = ("one_row", "single_pilot", "lattice", "full", "s1_k45", "density_1", "density_25",
              "comb", "block")
SLOT_CASES = ("full_column", "few_valid", "few_slots", "comb", "block")
#: densities of the frames of the comb and block cases (max density 0.15)
PATTERN_DENSITIES = {"comb": (0.01, 0.10, 0.15), "block": (0.01, 0.15)}
#: name → (systems, n, right-hand sides, condition number)
HPD_SHAPES = {
    "n1": (3, 1, 1, 100.0), "n2": (5, 2, 3, 100.0), "n8": (5, 8, 8, 100.0),
    "n9": (3, 9, 1, 100.0), "n16": (3, 16, 4, 100.0), "n17": (3, 17, 3, 100.0),
    "n31": (2, 31, 3, 100.0), "n32": (2, 32, 4, 100.0), "n33": (2, 33, 8, 100.0),
    "n48": (2, 48, 1, 100.0), "n49": (1, 49, 4, 100.0), "n63": (1, 63, 3, 100.0),
    "n64": (2, 64, 8, 100.0), "n65": (1, 65, 4, 100.0), "n96": (1, 96, 3, 100.0),
    "n97": (1, 97, 1, 100.0), "n128": (1, 128, 8, 100.0), "one_system": (1, 45, 4, 100.0),
    "cond_1e4": (5, 24, 4, 1e4), "not_pd": (7, 20, 4, 100.0), "nan_entry": (4, 20, 2, 100.0),
    "last_pivot": (4, 33, 3, 100.0),
    "n113": (1, 113, 8, 100.0), "n120": (2, 120, 8, 100.0), "n127": (1, 127, 8, 100.0),
    "n128_again": (1, 128, 8, 100.0),
}
HPD_CASES = tuple(HPD_SHAPES)


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _regular(name: str):
    """The comb or block pattern of PATTERN_DENSITIES[name] at 14 × 599."""
    from ..physics.pilots import make_pattern

    dens = PATTERN_DENSITIES[name]
    return make_pattern(torch.zeros(len(dens), 14 * 599), 14, 599, torch.tensor(dens), name)


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
    elif name in PATTERN_DENSITIES:
        mask = _regular(name).mask.numpy()
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
    elif name in PATTERN_DENSITIES:
        grid, pat = (14, 599), _regular(name)
        frames = list(zip(pat.positions.numpy(), pat.valid.numpy()))
        p = pat.valid.shape[1]
    else:
        raise ValueError(f"unknown slot case {name!r}")
    pos = np.stack([f[0] for f in frames])
    valid = np.stack([f[1] for f in frames])
    vals = np.ascontiguousarray(_complex(rng, (len(frames), max(r, 4), p))[:, :r]) * valid[:, None]
    return {"values": torch.from_numpy(vals), "positions": torch.from_numpy(pos),
            "valid": torch.from_numpy(valid), "grid": grid}


def hpd_case(name: str) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """(gram (B, n, n) complex64, exactly Hermitian; rhs (B, n, R) complex64;
    the indices of the systems that are not positive definite, whose
    solution must be NaN while the others stay finite)."""
    b, n, r, cond = HPD_SHAPES[name]
    rng = np.random.default_rng(200 + HPD_CASES.index(name))
    x = rng.standard_normal((b, n, n)) + 1j * rng.standard_normal((b, n, n))
    gram = x @ np.conj(np.swapaxes(x, 1, 2)) + (n / cond) * np.eye(n)
    gram = 0.5 * (gram + np.conj(np.swapaxes(gram, 1, 2)))
    bad: Tuple[int, ...] = ()
    if name == "not_pd":
        bad = (0, 3, 6)
        gram[0] = -np.eye(n)  # fails at the first pivot
        gram[3] -= 2.0 * np.linalg.eigvalsh(gram[3])[n // 2] * np.eye(n)  # indefinite
        gram[6] = -gram[6]
    elif name == "nan_entry":
        bad = (1,)
        gram[1, 5, 2] = gram[1, 2, 5] = np.nan
    elif name == "last_pivot":
        bad = (2,)
        chol = np.linalg.cholesky(gram[2])
        gram[2, n - 1, n - 1] -= 2.0 * chol[n - 1, n - 1].real ** 2  # last pivot -L²
    rhs = _complex(rng, (b, n, r))
    return torch.from_numpy(np.ascontiguousarray(gram, np.complex64)), torch.from_numpy(rhs), bad
