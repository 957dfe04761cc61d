"""Checkpoint I/O in the JAX package's format. Port of
``ce5g_tpu.train.checkpoint``: a checkpoint is a directory holding
``state.npz`` (the model: the flat flax-nnx arrays of
``convert.model_state_to_numpy``), ``meta.json`` and, for a resumable
checkpoint, ``opt_state.npz`` and ``rng_state.npz``. The JAX package's
``load_checkpoint`` reads the model of what :func:`save_checkpoint`
writes, and the other way round.

The optimizer and RNG files use the port's own names: ``opt_state.npz``
is the torch optimizer's ``state_dict`` (``state/<param index>/<name>``
arrays, and its ``param_groups`` as JSON in ``param_groups``), and
``rng_state.npz`` holds the generator states that drive dropout (``cpu``,
and ``cuda`` for a model on the card). Neither package reads the other's
optimizer state.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..convert import model_state_from_numpy, model_state_to_numpy


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _save_optimizer(optimizer: torch.optim.Optimizer, path: Path) -> None:
    sd = optimizer.state_dict()
    arrays = {"param_groups": np.array(json.dumps(sd["param_groups"]))}
    for idx, state in sd["state"].items():
        for name, value in state.items():
            arrays[f"state/{idx}/{name}"] = torch.as_tensor(value).detach().cpu().numpy()
    np.savez(path / "opt_state.npz", **arrays)


def _load_optimizer(optimizer: torch.optim.Optimizer, path: Path) -> None:
    with np.load(path / "opt_state.npz", allow_pickle=False) as z:
        groups = json.loads(str(z["param_groups"]))
        state: Dict[int, Dict[str, torch.Tensor]] = {}
        for key in z.files:
            if key.startswith("state/"):
                _, idx, name = key.split("/", 2)
                state.setdefault(int(idx), {})[name] = torch.from_numpy(z[key])
    optimizer.load_state_dict({"state": state, "param_groups": groups})


def _save_rng(model: nn.Module, path: Path) -> None:
    arrays = {"cpu": torch.get_rng_state().numpy()}
    dev = _model_device(model)
    if dev.type == "cuda":
        arrays["cuda"] = torch.cuda.get_rng_state(dev).numpy()
    np.savez(path / "rng_state.npz", **arrays)


def _load_rng(model: nn.Module, path: Path) -> None:
    with np.load(path / "rng_state.npz", allow_pickle=False) as z:
        torch.set_rng_state(torch.from_numpy(z["cpu"]))
        dev = _model_device(model)
        if dev.type == "cuda" and "cuda" in z.files:
            torch.cuda.set_rng_state(torch.from_numpy(z["cuda"]), dev)


def save_checkpoint(path, model: nn.Module, optimizer=None, **metadata) -> None:
    """Write ``model``'s state (+ JSON metadata) under ``path``, a
    directory, in the JAX package's layout. Passing ``optimizer`` makes
    the checkpoint resumable: its state and the dropout generators' go
    beside the model's."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "state.npz", **model_state_to_numpy(model))
    if optimizer is not None:
        _save_optimizer(optimizer, path)
        _save_rng(model, path)
    (path / "meta.json").write_text(json.dumps(metadata, default=float, indent=2))


def load_checkpoint(path, model: nn.Module, optimizer=None) -> Dict[str, Any]:
    """Fill ``model`` (and ``optimizer`` when given) in place from
    ``path``; return the metadata dict (empty without ``meta.json``).
    With ``optimizer``, a checkpoint saved without optimizer state raises
    ``FileNotFoundError``."""
    path = Path(path)
    with np.load(path / "state.npz") as z:
        model_state_from_numpy({k: z[k] for k in z.files}, model)
    if optimizer is not None:
        opt_path = path / "opt_state.npz"
        if not opt_path.exists():
            raise FileNotFoundError(
                f"{opt_path} missing: checkpoint was saved without optimizer "
                "state and cannot resume training"
            )
        _load_optimizer(optimizer, path)
        if (path / "rng_state.npz").exists():
            _load_rng(model, path)
    meta_path = path / "meta.json"
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}
