"""Split generation: per-frame parameter draws → simulation → LS feature,
and the npz chunk files. Port of the part of ``ce5g_tpu.data.generator``
that feeds a split (reference dataset_generator.py:66-117, 145-180).

The JAX package draws every frame from a PRNG key; here the parameters
come from a ``torch.Generator`` (:func:`draw_params`) and the frame's
random numbers arrive as ``physics.FrameDraws``, so a test can inject the
JAX package's own draws. ``DatasetGenerator``, its manifests and the
``.ce5g`` container and ``.h5`` files come with the dataset-factory slice
of the port.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..device import resolve_device
from ..estimators.api import estimate_batch
from ..physics.profiles import PROFILE_INDEX, ProfileTable
from ..physics.simulate import FrameDraws, FrameParams, simulate_batch

#: arrays stored per split (reference sample dict, dataset_generator.py:77-87)
CHUNK_KEYS = (
    "rx_symbols",
    "tx_symbols",
    "H_true",
    "H_ls",
    "pilot_mask",
    "snr_db",
    "doppler_hz",
    "pilot_density",
    "profile_idx",
)


def draw_params(cfg: ExperimentConfig, n: int, generator: torch.Generator,
                device="cuda") -> FrameParams:
    """``n`` frames' parameters, each drawn uniformly and independently from
    the config lists (reference dataset_generator.py:114-117). The
    generator must live on ``device``."""
    dev = resolve_device(device)

    def pick(values, dtype):
        table = torch.as_tensor(values, dtype=dtype, device=dev)
        return table[torch.randint(len(values), (n,), generator=generator, device=dev)]

    return FrameParams(
        profile_idx=pick([PROFILE_INDEX[m] for m in cfg.channel.models], torch.int32),
        doppler_hz=pick(cfg.channel.doppler_hz, torch.float32),
        snr_db=pick(cfg.simulation.snr_range_db, torch.float32),
        pilot_density=pick(cfg.pilots.density, torch.float32),
    )


def generate_chunk(cfg: ExperimentConfig, params: FrameParams, draws: FrameDraws,
                   table: Optional[ProfileTable] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Simulate the frames of ``params``/``draws`` and their LS feature
    (``cfg.pilots.interpolation``): the chunk dict of ``CHUNK_KEYS``, every
    tensor on ``device``."""
    dev = resolve_device(device)
    frames = simulate_batch(draws, params, cfg=cfg, table=table, device=dev)
    h_ls = estimate_batch(frames, cfg=cfg, estimator="ls", method=cfg.pilots.interpolation,
                          table=table, device=dev)
    p = frames.params
    return {
        "rx_symbols": frames.rx_symbols,
        "tx_symbols": frames.tx_symbols,
        "H_true": frames.channel,
        "H_ls": h_ls,
        "pilot_mask": frames.pilot_mask,
        "snr_db": p.snr_db,
        "doppler_hz": p.doppler_hz,
        "pilot_density": p.pilot_density,
        "profile_idx": p.profile_idx,
    }


# ----------------------------------------------------------------- file I/O
_FACTORY_SLICE = "come with the dataset-factory slice of the port; use .npz"


def _write_npz(path: Path, arrays: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **arrays)


def read_chunk(path) -> Dict[str, np.ndarray]:
    """The arrays of one .npz chunk or merged split."""
    p = Path(path)
    if p.suffix in (".h5", ".ce5g"):
        raise NotImplementedError(f"{p.suffix} files {_FACTORY_SLICE}")
    with np.load(p, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def read_split(path) -> Dict[str, np.ndarray]:
    """Load a merged file or a manifest (concatenating its chunks)."""
    p = Path(path)
    if p.suffix == ".json":
        manifest = json.loads(p.read_text())
        parts = [read_chunk(p.parent / f) for f in manifest["files"]]
        return {k: np.concatenate([q[k] for q in parts], axis=0) for k in parts[0]}
    return read_chunk(p)
