"""ResNet channel estimator (reference ResidualBlock /
ResNetChannelEstimator, src/ai_models.py:228-301): 7×7 input conv → N
residual blocks (conv-bn-relu-dropout-conv-bn + skip) → 1×1 out. Port of
``ce5g_tpu.models.resnet``; NHWC outside, (B, C, S, K) inside (see
``models.cnn``)."""
from __future__ import annotations

import torch
from torch import nn

from .cnn import BatchNorm, computing_in, to_channels_first


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, dropout: float):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = BatchNorm(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = BatchNorm(channels)
        self.drop = nn.Dropout2d(dropout)  # reference nn.Dropout2d (ai_models.py:238)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop(torch.relu(self.bn1(self.conv1(x))))
        y = self.bn2(self.conv2(y))
        return torch.relu(x + y)


class ResNetChannelEstimator(nn.Module):
    """(B, S, K, in_ch) → (B, S, K, 2) float32."""

    def __init__(
        self,
        in_channels: int = 5,
        base_channels: int = 64,
        num_blocks: int = 4,
        dropout: float = 0.1,
        *,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.stem = nn.Conv2d(in_channels, base_channels, 7, padding=3)
        self.stem_bn = BatchNorm(base_channels)
        self.blocks = nn.ModuleList(
            ResidualBlock(base_channels, dropout) for _ in range(num_blocks)
        )
        self.out = nn.Conv2d(base_channels, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with computing_in(self.dtype, x.device):
            h = to_channels_first(x)
            h = torch.relu(self.stem_bn(self.stem(h)))
            for block in self.blocks:
                h = block(h)
            h = self.out(h)
        return h.float().permute(0, 2, 3, 1).contiguous()
