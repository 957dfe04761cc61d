"""Carry state from the JAX package into the port, through numpy.

``ce5g_torch`` never imports JAX: the caller turns a JAX ``Frame`` or
``ProfileTable`` into numpy arrays (``np.asarray`` on each field) and
hands the mapping here. The layouts are the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

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
