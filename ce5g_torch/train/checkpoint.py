"""Checkpoint I/O in the JAX package's format. Port of the model half of
``ce5g_tpu.train.checkpoint``: a checkpoint is a directory holding
``state.npz`` (the flat flax-nnx arrays, ``convert.model_state_from_numpy``)
and ``meta.json``. The JAX package's ``load_checkpoint`` reads what
:func:`save_checkpoint` writes, and the other way round.

Optimizer and RNG state (``opt_state.npz``, ``rng_state.npz``) come with
the training slice of the port.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
from torch import nn

from ..convert import model_state_from_numpy, model_state_to_numpy

_TRAINING_SLICE = (
    "optimizer state in checkpoints comes with the training slice of the port"
)


def save_checkpoint(path, model: nn.Module, optimizer=None, **metadata) -> None:
    """Write ``model``'s state (+ JSON metadata) under ``path``, a
    directory, in the JAX package's layout."""
    if optimizer is not None:
        raise NotImplementedError(_TRAINING_SLICE)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "state.npz", **model_state_to_numpy(model))
    (path / "meta.json").write_text(json.dumps(metadata, default=float, indent=2))


def load_checkpoint(path, model: nn.Module, optimizer=None) -> Dict[str, Any]:
    """Fill ``model`` in place from ``path``/state.npz; return the
    metadata dict (empty without ``meta.json``)."""
    if optimizer is not None:
        raise NotImplementedError(_TRAINING_SLICE)
    path = Path(path)
    with np.load(path / "state.npz") as z:
        model_state_from_numpy({k: z[k] for k in z.files}, model)
    meta_path = path / "meta.json"
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}
