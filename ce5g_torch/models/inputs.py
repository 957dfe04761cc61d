"""ML input/target layouts.

Port of ``ce5g_tpu.models.inputs`` (reference src/train.py:63-94 and
run_phase4_training.py:95-103): the 5-channel real grid [rx_re, rx_im,
H_ls_re, H_ls_im, pilot_mask] over the first antenna pair, targets
[H_re, H_im], channel-last ``(B, S, K, C)``; and the LSTM's flattened
``(S·K, 4)`` sequence layout (run_phase6_advanced_training.py:96-105).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

_UNIT_STATS = {"rx_std": 1.0, "hls_std": 1.0, "h_std": 1.0}


class MLBatch(NamedTuple):
    """One batch: NHWC inputs/targets + pilot mask + normalisers."""

    inputs: Any  # (B, S, K, 5 or 7) float32
    targets: Any  # (B, S, K, 2) float32
    pilot_mask: Any  # (B, S, K) float32
    stats: Optional[Dict[str, float]] = None


def grid_inputs(rx, h_ls, h_true, pilot_mask, stats: Optional[Dict] = None) -> MLBatch:
    """The 5-channel grid batch from complex frame tensors.

    Args:
        rx: (B, S, R, K) complex received grid.
        h_ls: (B, S, R, T, K) complex LS estimate (input feature).
        h_true: (B, S, R, T, K) complex true channel (target).
        pilot_mask: (B, S, K) mask.
        stats: optional {rx_std, hls_std, h_std} normalisers.

    Uses the first (rx, tx) antenna pair (run_phase4_training.py:95-103).
    """
    st = stats or _UNIT_STATS
    rx0 = rx[:, :, 0, :]
    ls0 = h_ls[:, :, 0, 0, :]
    ht0 = h_true[:, :, 0, 0, :]
    mask = torch.as_tensor(pilot_mask).to(torch.float32)
    inputs = torch.stack(
        [
            rx0.real / st["rx_std"],
            rx0.imag / st["rx_std"],
            ls0.real / st["hls_std"],
            ls0.imag / st["hls_std"],
            mask,
        ],
        dim=-1,
    ).to(torch.float32)
    targets = torch.stack(
        [ht0.real / st["h_std"], ht0.imag / st["h_std"]], dim=-1
    ).to(torch.float32)
    return MLBatch(inputs, targets, mask, st)


def apply_output_residual(pred: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """Residual-on-Wiener output head: with the 7-channel layout of
    ``ChannelDataset(wiener=True)`` the model's output is a residual on the
    Wiener feature (channels 5:7), Ĥ = Ĥ_wiener + f(x). Decided on the
    static channel count; the 5-channel layout passes through."""
    if inputs.shape[-1] >= 7:
        return pred + inputs[..., 5:7].to(pred.dtype)
    return pred


def lstm_inputs(batch: MLBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened sequence layout for the pure-LSTM model: drop the
    pilot-mask channel, fold the (S, K) grid into one S·K sequence."""
    x = torch.as_tensor(batch.inputs)
    y = torch.as_tensor(batch.targets)
    b, s, k, _ = x.shape
    return x[..., :4].reshape(b, s * k, 4), y.reshape(b, s * k, 2)
