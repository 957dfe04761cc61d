"""CNN channel estimator (reference CNNChannelEstimator,
src/ai_models.py:17-73): Conv stack + BatchNorm + ReLU + Dropout2d, 1×1
output conv to 2 channels. Port of ``ce5g_tpu.models.cnn``.

The public layout is NHWC ``(B, S, K, C)`` as in the JAX package. Inside,
the grid models copy it once to NCHW ``(B, C, S, K)`` and convolve there:
in full float32 cuDNN's fastest convolutions on the H100 are NCHW kernels,
and with channels_last it transposes around each of them (cnn 11.1 vs
12.3 ms, resnet 6.2 vs 7.5 ms a batch of 32 SIMO frames on an H100;
PERF.md §6). TF32 or bf16 may reverse this.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def computing_in(dtype: torch.dtype, device: torch.device):
    """Compute in ``dtype`` while the parameters stay float32 (the JAX
    models' ``dtype``/``param_dtype`` split): autocast for a half type,
    nothing for float32."""
    return torch.autocast(device.type, dtype=dtype, enabled=dtype != torch.float32)


def to_channels_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, K, C) → (B, C, S, K), contiguous (NCHW)."""
    return x.permute(0, 3, 1, 2).contiguous()


class BatchNorm(nn.BatchNorm2d):
    """flax ``nnx.BatchNorm`` on (B, C, S, K): ε 1e-5, and in train mode
    running statistics that move as flax's do. flax keeps momentum 0.99
    (0.01 in torch's terms) and averages the *biased* batch variance,
    where torch averages the unbiased one. The statistics are float32
    under a half compute dtype, as flax's reductions are. Eval mode, and
    the buffer names that ``convert`` maps to flax's scale/bias/mean/var,
    are torch's."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # momentum 1 leaves the batch's own mean and unbiased variance in
        # the scratch buffers, from the same fused pass that normalises
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
            self.num_batches_tracked += 1
        return y


class ConvBlock(nn.Module):
    """conv → batchnorm → relu → channel dropout, on (B, C, S, K).

    ``"SAME"`` padding of an odd kernel is symmetric."""

    def __init__(self, c_in: int, c_out: int, kernel: int, dropout: float):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, padding=kernel // 2)
        self.bn = BatchNorm(c_out)
        self.drop = nn.Dropout2d(dropout)  # reference nn.Dropout2d (ai_models.py:54)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(torch.relu(self.bn(self.conv(x))))


class CNNChannelEstimator(nn.Module):
    """(B, S, K, in_ch) → (B, S, K, 2) float32."""

    def __init__(
        self,
        in_channels: int = 5,
        hidden_channels: Tuple[int, ...] = (64, 128, 256, 128, 64),
        kernel_size: int = 3,
        dropout: float = 0.1,
        *,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        blocks = []
        c_prev = in_channels
        for c in hidden_channels:
            blocks.append(ConvBlock(c_prev, c, kernel_size, dropout))
            c_prev = c
        self.blocks = nn.ModuleList(blocks)
        self.out = nn.Conv2d(c_prev, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with computing_in(self.dtype, x.device):
            h = to_channels_first(x)
            for block in self.blocks:
                h = block(h)
            h = self.out(h)
        return h.float().permute(0, 2, 3, 1).contiguous()
