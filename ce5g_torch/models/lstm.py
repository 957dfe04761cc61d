"""Bidirectional multi-layer LSTM estimator (reference
LSTMChannelEstimator, src/ai_models.py:76-130): stacked LSTM layers over a
flattened (S·K, 4) sequence, Linear head to 2. Port of
``ce5g_tpu.models.lstm`` on ``nn.LSTM``.

flax's ``OptimizedLSTMCell`` computes the gates (i, f, g, o, torch's
order) as ``dense_i(x) + dense_h(h)`` with a bias on ``dense_h`` only. So
each ``nn.LSTM`` here keeps ``bias_ih`` at zero and frozen, and
``bias_hh`` carries ``dense_h``'s bias. flax's ``reverse=True,
keep_order=True`` RNN is torch's backward direction.
"""
from __future__ import annotations

import torch
from torch import nn

from .cnn import computing_in


class LSTMLayer(nn.Module):
    """One LSTM layer over axis 1 of (N, L, F): forward only, or forward
    and backward with the features concatenated."""

    def __init__(self, in_features: int, hidden: int, bidirectional: bool):
        super().__init__()
        self.rnn = nn.LSTM(in_features, hidden, batch_first=True,
                           bidirectional=bidirectional)
        with torch.no_grad():
            for name, p in self.rnn.named_parameters():
                if name.startswith("bias_ih"):
                    p.zero_()
                    p.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rnn(x)[0]

    def flax_entries(self, path):
        """(flax name, tensor, flax → torch, torch → flax) for each array of
        the ``nnx.OptimizedLSTMCell`` of each direction at ``path``: dense_i
        kernel (in, 4H), no bias; dense_h kernel (H, 4H) and bias (4H,). The
        frozen zero ``bias_ih`` has no counterpart.
        ``convert.model_state_from_numpy`` reads these."""
        def transposed(a):
            return a.T

        def same(a):
            return a

        dirs = (("fwd",), ""), (("bwd",), "_reverse")
        for prefix, suffix in dirs if self.rnn.bidirectional else (((), ""),):
            cell = path + prefix + ("cell",)
            yield ("/".join(cell + ("dense_i", "kernel")),
                   getattr(self.rnn, f"weight_ih_l0{suffix}"), transposed, transposed)
            yield ("/".join(cell + ("dense_h", "kernel")),
                   getattr(self.rnn, f"weight_hh_l0{suffix}"), transposed, transposed)
            yield ("/".join(cell + ("dense_h", "bias")),
                   getattr(self.rnn, f"bias_hh_l0{suffix}"), same, same)


class BiLSTMLayer(LSTMLayer):
    """Forward + backward LSTM over axis 1, features concatenated."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__(in_features, hidden, bidirectional=True)


class LSTMChannelEstimator(nn.Module):
    """(B, L, in_features) → (B, L, 2) float32."""

    def __init__(
        self,
        in_features: int = 4,
        hidden_size: int = 256,
        num_layers: int = 3,
        bidirectional: bool = True,
        dropout: float = 0.2,
        *,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.bidirectional = bidirectional
        layers = []
        f_in = in_features
        for _ in range(num_layers):
            layers.append(LSTMLayer(f_in, hidden_size, bidirectional))
            f_in = 2 * hidden_size if bidirectional else hidden_size
        self.layers = nn.ModuleList(layers)
        self.drop = nn.Dropout(dropout)  # between layers only, as torch nn.LSTM
        self.head = nn.Linear(f_in, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with computing_in(self.dtype, x.device):
            for i, layer in enumerate(self.layers):
                x = layer(x)
                if i + 1 < len(self.layers):
                    x = self.drop(x)
            out = self.head(x)
        return out.float()
