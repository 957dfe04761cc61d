"""Transfers between the host and the device.

The JAX package's ``get_numpy`` and ``put_complex`` work around a TPU
runtime that cannot move complex64 either way: they split complex arrays
into real and imaginary parts and join them on the other side. CUDA moves
complex64 as it is, so here they are a plain tree map of
``.cpu().numpy()`` and one copy, kept so that code written against either
package reads the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .tree import tree_map


def get_numpy(tree):
    """Every tensor leaf of ``tree`` as a numpy array on the host; other
    leaves pass through."""
    def fetch(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    return tree_map(fetch, tree)


def put_complex(x, device="cuda") -> torch.Tensor:
    """A host array (complex or real) as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))
