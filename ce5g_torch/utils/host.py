"""Device→host transfer of a tree of tensors.

The JAX package's ``get_numpy`` works around a TPU runtime that cannot
move complex64 to the host: it splits complex leaves into real and
imaginary parts on the device and joins them on the host. CUDA moves
complex64 as it is, so here it is a plain tree map of ``.cpu().numpy()``,
kept so that code written against either package reads the same.
"""
from __future__ import annotations

import torch

from .tree import tree_map


def get_numpy(tree):
    """Every tensor leaf of ``tree`` as a numpy array on the host; other
    leaves pass through."""
    def fetch(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    return tree_map(fetch, tree)
