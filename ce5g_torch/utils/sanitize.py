"""Numeric sanitizers.

Port of ``ce5g_tpu.utils.sanitize`` (the reference's only sanitizers are
the NaN/Inf scans of test_phase1_transmission.py:105-107 and
verify_phase3_datasets.py:96-113):

  * :func:`debug_nans` — within the scope, the first torch operation
    whose floating output holds a NaN raises ``FloatingPointError`` with
    the operation's name (torch has no ``jax_debug_nans``);
  * :func:`assert_finite` — an all-finite check over a tree of tensors
    that stays on the device (a bool tensor), failing hard on the host
    only when asked;
  * :func:`finite_report` — the per-leaf NaN/Inf census on the host, keyed
    as ``jax.tree_util.keystr`` keys the JAX package's.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .tree import leaves_with_path


class _RaiseOnNaN(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for _, leaf in leaves_with_path(out):
            if (isinstance(leaf, torch.Tensor) and (leaf.is_floating_point() or leaf.is_complex())
                    and bool(torch.isnan(leaf).any())):
                name = getattr(func, "__qualname__", None) or getattr(func, "__name__", str(func))
                raise FloatingPointError(f"NaN in the output of {name}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the scope, raise ``FloatingPointError`` at the first torch
    operation that returns a floating tensor holding a NaN.

    Each operation's output is checked on the host when it returns, so
    every operation synchronises the device once: a debugging aid, not a
    mode to run a workload in."""
    if not enable:
        yield
        return
    with _RaiseOnNaN():
        yield


def _leaf_finite(x: torch.Tensor) -> torch.Tensor:
    if x.is_floating_point() or x.is_complex():
        return torch.isfinite(x).all()
    return torch.ones((), dtype=torch.bool, device=x.device)


def assert_finite(tree, name: str = "tree", hard: bool = False) -> torch.Tensor:
    """All-finite check over the tensors of ``tree``: a bool tensor on the
    first leaf's device, computed without a host synchronisation.

    With ``hard=True`` it synchronises and raises ``FloatingPointError``
    when any leaf holds a NaN or Inf."""
    leaves = [x for _, x in leaves_with_path(tree) if isinstance(x, torch.Tensor)]
    if not leaves:
        ok = torch.ones((), dtype=torch.bool)
    else:
        dev = leaves[0].device
        ok = torch.stack([_leaf_finite(x).to(dev) for x in leaves]).all()
    if hard and not bool(ok):
        raise FloatingPointError(f"non-finite values in {name}: {finite_report(tree)}")
    return ok


def finite_report(tree) -> Dict[str, Dict[str, int]]:
    """Host-side census of NaN/Inf counts, non-finite leaves only."""
    out: Dict[str, Dict[str, int]] = {}
    for path, leaf in leaves_with_path(tree):
        a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if a.dtype.kind not in "fc":
            continue
        parts = (a.real, a.imag) if a.dtype.kind == "c" else (a,)
        nan = sum(int(np.isnan(p).sum()) for p in parts)
        inf = sum(int(np.isinf(p).sum()) for p in parts)
        if nan or inf:
            out[path] = {"nan": nan, "inf": inf}
    return out
