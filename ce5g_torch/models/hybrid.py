"""Hybrid CNN+LSTM estimator (reference HybridCNNLSTMEstimator,
src/ai_models.py:133-225). Port of ``ce5g_tpu.models.hybrid``: the
subcarrier axis folds into the batch, so all K time sequences run as one
biLSTM over the symbol axis."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .cnn import ConvBlock, computing_in, to_channels_first
from .lstm import BiLSTMLayer


class HybridCNNLSTMEstimator(nn.Module):
    """(B, S, K, in_ch) → (B, S, K, 2) float32."""

    def __init__(
        self,
        in_channels: int = 5,
        cnn_channels: Tuple[int, ...] = (32, 64, 128),
        lstm_hidden: int = 256,
        lstm_layers: int = 2,
        dropout: float = 0.1,
        *,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        blocks = []
        c_prev = in_channels
        for c in cnn_channels:
            blocks.append(ConvBlock(c_prev, c, 3, dropout))
            c_prev = c
        self.cnn = nn.ModuleList(blocks)
        lstms = []
        f_in = c_prev
        for _ in range(lstm_layers):
            lstms.append(BiLSTMLayer(f_in, lstm_hidden))
            f_in = 2 * lstm_hidden
        self.lstm = nn.ModuleList(lstms)
        self.head = nn.Linear(f_in, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, k, _ = x.shape
        with computing_in(self.dtype, x.device):
            h = to_channels_first(x)
            for block in self.cnn:
                h = block(h)
            # (B, C, S, K) → (B·K, S, C): every subcarrier is its own sequence
            h = h.permute(0, 3, 2, 1).reshape(b * k, s, h.shape[1])
            for layer in self.lstm:
                h = layer(h)
            h = self.head(h)  # (B·K, S, 2)
        return h.float().reshape(b, k, s, 2).transpose(1, 2).contiguous()
