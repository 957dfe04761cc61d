"""Deterministic per-chunk generators for the dataset factory.

Port of ``ce5g_tpu.utils.rng``. The JAX package keys every sample with
``fold_in(split_key, idx)``; torch has no counter-based key to fold, so
here a chunk of a split owns one ``torch.Generator`` seeded from
``np.random.SeedSequence((seed, split tag, chunk index, chunk size))``,
as ``eval.parity`` seeds its cells. The reproducibility rule of the port:
a sample is a pure function of (seed, split, chunk size, index, device
type). A chunk always draws and simulates its full ``chunk_size`` frames
and then slices, so a trailing partial chunk is bitwise the prefix of the
full one, a regenerated chunk is bitwise the one it replaces, and the
union over writers equals one writer's output.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

# Split names get stable integer tags (parity with the reference's
# split-keyed seeds {train:42, val:123, test:456},
# run_phase3_dataset_generation.py:98-101 — ours are tags, not seeds).
SPLIT_TAGS = {"train": 0, "val": 1, "test": 2}


def split_tag(split: str) -> int:
    """The split's integer tag: fixed for train/val/test, else the CRC-32
    of its name (stable across processes, unlike the salted ``hash``)."""
    return SPLIT_TAGS.get(split, zlib.crc32(split.encode()))


def chunk_seed(seed: int, split: str, chunk_idx: int, chunk_size: int) -> int:
    """The 64-bit seed of chunk ``chunk_idx`` of ``split`` at ``chunk_size``."""
    state = np.random.SeedSequence((seed, split_tag(split), chunk_idx, chunk_size))
    return int(state.generate_state(1, np.uint64)[0])


def chunk_generator(seed: int, split: str, chunk_idx: int, chunk_size: int,
                    device="cuda") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` that draws chunk ``chunk_idx``."""
    return torch.Generator(device=device).manual_seed(
        chunk_seed(seed, split, chunk_idx, chunk_size))
