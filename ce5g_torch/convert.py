"""Carry state from the JAX package into the port, through numpy.

``ce5g_torch`` never imports JAX: the caller turns a JAX ``Frame`` or
``ProfileTable`` into numpy arrays (``np.asarray`` on each field) and
hands the mapping here. The layouts are the same in both packages.

Model weights travel as the flat mapping that the JAX package's
checkpoints hold in ``state.npz`` (``ce5g_tpu/train/checkpoint.py:21-28``):
``{'blocks/0/conv/kernel': array, ...}``, the flax-nnx module path of each
parameter and BatchNorm statistic. :func:`model_state_from_numpy` fills a
port model from it and :func:`model_state_to_numpy` writes it back. The
layouts of torch's own layers are mapped here; a port module whose flax
layout differs from torch's (attention, LSTM) names its arrays itself,
through a ``flax_entries(path)`` method.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .physics.profiles import ProfileTable
from .physics.simulate import Frame, FrameParams

#: the JAX ProfileTable's fields (the port's table adds only its cache)
_TABLE_FIELDS = tuple(
    f.name for f in dataclasses.fields(ProfileTable) if not f.name.startswith("_")
)

def _fields(obj: Any) -> Mapping[str, Any]:
    """A mapping of field name → value from a mapping or a named tuple."""
    if isinstance(obj, Mapping):
        return obj
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    raise TypeError(f"expected a mapping or a named tuple, got {type(obj).__name__}")


def frame_from_numpy(d: Any, device="cuda") -> Frame:
    """A port :class:`Frame` on ``device`` from numpy arrays with the
    JAX ``Frame`` field names (batched or not), ``params`` included as a
    mapping or named tuple."""
    dev = resolve_device(device)
    d = _fields(d)

    def t(x):
        return torch.tensor(np.asarray(x), device=dev)

    params = _fields(d["params"])
    return Frame(
        *(t(d[name]) for name in Frame._fields[:-1]),
        FrameParams(*(t(params[name]) for name in FrameParams._fields)),
    )


def profile_table_from_numpy(d: Any) -> ProfileTable:
    """A port :class:`ProfileTable` from numpy arrays with the JAX
    ``ProfileTable`` field names (a mapping, or any object with those
    attributes, such as the JAX table itself)."""
    if not isinstance(d, Mapping):
        d = {name: getattr(d, name) for name in _TABLE_FIELDS}
    return ProfileTable(
        **{name: np.asarray(d[name]) for name in _TABLE_FIELDS if name != "sampling_rate"},
        sampling_rate=float(d["sampling_rate"]),
    )


class _Entry(NamedTuple):
    """One array of a flat JAX checkpoint and the port tensor it fills."""

    name: str  # flax-nnx path, 'blocks/0/conv/kernel'
    tensor: torch.Tensor
    to_torch: Callable[[np.ndarray], np.ndarray]  # flax layout → torch layout
    to_flax: Callable[[np.ndarray], np.ndarray]


_SAME = (lambda a: a, lambda a: a)
_TRANSPOSED = (lambda a: a.T, lambda a: a.T)
# flax Conv kernels are (kh, kw, in, out); torch's are (out, in, kh, kw)
_CONV = (lambda a: a.transpose(3, 2, 0, 1), lambda a: a.transpose(2, 3, 1, 0))


def _entries(module: nn.Module, path: Tuple[str, ...] = ()) -> Iterator[_Entry]:
    """Every flax array of ``module``, by walking it: child names are the
    flax attribute names, ``nn.ModuleList`` indices are the ``nnx.List``
    indices."""
    def at(name):
        return "/".join(path + (name,))

    if isinstance(module, nn.Conv2d):
        yield _Entry(at("kernel"), module.weight, *_CONV)
        yield _Entry(at("bias"), module.bias, *_SAME)
    elif isinstance(module, nn.Linear):
        yield _Entry(at("kernel"), module.weight, *_TRANSPOSED)
        yield _Entry(at("bias"), module.bias, *_SAME)
    elif isinstance(module, nn.BatchNorm2d):
        for flax_name, tensor in (("scale", module.weight), ("bias", module.bias),
                                  ("mean", module.running_mean), ("var", module.running_var)):
            yield _Entry(at(flax_name), tensor, *_SAME)
    elif isinstance(module, nn.LayerNorm):
        yield _Entry(at("scale"), module.weight, *_SAME)
        yield _Entry(at("bias"), module.bias, *_SAME)
    elif hasattr(module, "flax_entries"):  # a module whose flax layout is its own
        yield from (_Entry(*e) for e in module.flax_entries(path))
    else:
        for name, p in module.named_parameters(recurse=False):
            yield _Entry(at(name), p, *_SAME)
        for name, child in module.named_children():
            yield from _entries(child, path + (name,))


def model_state_from_numpy(flat: Mapping[str, np.ndarray], model: nn.Module) -> nn.Module:
    """Fill ``model`` in place from a flat JAX checkpoint mapping (the
    arrays of ``state.npz``) and return it. Raises ``ValueError`` on a
    missing, extra or misshaped key."""
    entries = list(_entries(model))
    names = {e.name for e in entries}
    missing, extra = sorted(names - set(flat)), sorted(set(flat) - names)
    if missing or extra:
        raise ValueError(f"checkpoint does not fit {type(model).__name__}: "
                         f"missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for e in entries:
            arr = np.asarray(flat[e.name])
            want = e.to_flax(e.tensor.detach().cpu().numpy()).shape
            if arr.shape != want:
                raise ValueError(f"{e.name}: checkpoint shape {arr.shape}, model shape {want}")
            src = torch.from_numpy(np.ascontiguousarray(e.to_torch(arr)))
            e.tensor.copy_(src.to(e.tensor.dtype))
    return model


def model_state_to_numpy(model: nn.Module) -> Dict[str, np.ndarray]:
    """The flat mapping that :func:`model_state_from_numpy` reads, in the
    JAX package's names and layouts."""
    return {
        e.name: np.ascontiguousarray(e.to_flax(e.tensor.detach().cpu().numpy()))
        for e in _entries(model)
    }
