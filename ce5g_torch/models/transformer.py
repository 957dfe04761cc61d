"""Axial Transformer channel estimator. Port of
``ce5g_tpu.models.transformer``: alternating attention along the
subcarrier axis and the symbol axis, each a pre-LN block with an MLP.

Where flax and torch differ by default, the JAX package's values are
kept: LayerNorm ε = 1e-6, the tanh approximation of GELU, and
``nnx.MultiHeadAttention``'s layout (query/key/value kernels
(d, heads, d/heads), out kernel (heads, d/heads, d), logits scaled by
1/√(d/heads)). The attention itself is ``F.scaled_dot_product_attention``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .cnn import computing_in


class MultiHeadAttention(nn.Module):
    """Self-attention over axis 1 of (batch', L, d), no attention dropout
    (flax's default rate of 0)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, d = x.shape

        def heads(t):
            return t.view(b, length, self.num_heads, self.head_dim).transpose(1, 2)

        o = F.scaled_dot_product_attention(heads(self.query(x)), heads(self.key(x)),
                                           heads(self.value(x)))
        return self.out(o.transpose(1, 2).reshape(b, length, d))

    def flax_entries(self, path):
        """(flax name, tensor, flax → torch, torch → flax) for each array of
        ``nnx.MultiHeadAttention`` at ``path``: query/key/value kernels
        (d, heads, dh) with biases (heads, dh); out kernel (heads, dh, d),
        bias (d,). ``convert.model_state_from_numpy`` reads these."""
        h, dh = self.num_heads, self.head_dim
        for name in ("query", "key", "value"):
            lin = getattr(self, name)
            yield ("/".join(path + (name, "kernel")), lin.weight,
                   lambda a: a.reshape(a.shape[0], -1).T, lambda a: a.T.reshape(-1, h, dh))
            yield ("/".join(path + (name, "bias")), lin.bias,
                   lambda a: a.reshape(-1), lambda a: a.reshape(h, dh))
        yield ("/".join(path + ("out", "kernel")), self.out.weight,
               lambda a: a.reshape(h * dh, -1).T, lambda a: a.T.reshape(h, dh, -1))
        yield ("/".join(path + ("out", "bias")), self.out.bias, lambda a: a, lambda a: a)


class AxialBlock(nn.Module):
    """Pre-LN attention over one grid axis + MLP, both residual."""

    def __init__(self, d_model: int, num_heads: int, dropout: float):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=1e-6)
        self.attn = MultiHeadAttention(d_model, num_heads)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-6)
        self.fc1 = nn.Linear(d_model, 4 * d_model)
        self.fc2 = nn.Linear(4 * d_model, d_model)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (batch', L, d) — the caller folds the other grid axis into batch'
        x = x + self.attn(self.ln1(x))
        h = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))
        return x + self.drop(h)


class TransformerChannelEstimator(nn.Module):
    """(B, S, K, in_ch) → (B, S, K, 2) float32; S ≤ 256, K ≤ 4096."""

    def __init__(
        self,
        in_channels: int = 5,
        d_model: int = 64,
        num_heads: int = 4,
        num_layers: int = 2,
        dropout: float = 0.1,
        *,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.d_model = d_model
        self.embed = nn.Linear(in_channels, d_model)
        # learned axial positional embeddings, added per axis
        self.pos_s = nn.Parameter(0.02 * torch.randn(1, 256, 1, d_model))
        self.pos_k = nn.Parameter(0.02 * torch.randn(1, 1, 4096, d_model))
        self.freq_blocks = nn.ModuleList(
            AxialBlock(d_model, num_heads, dropout) for _ in range(num_layers)
        )
        self.time_blocks = nn.ModuleList(
            AxialBlock(d_model, num_heads, dropout) for _ in range(num_layers)
        )
        self.head = nn.Linear(d_model, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, k, _ = x.shape
        d = self.d_model
        with computing_in(self.dtype, x.device):
            x = self.embed(x) + self.pos_s[:, :s] + self.pos_k[:, :, :k]
            for fb, tb in zip(self.freq_blocks, self.time_blocks):
                # attention along subcarriers: fold S into the batch
                x = fb(x.reshape(b * s, k, d)).reshape(b, s, k, d)
                # attention along symbols: fold K into the batch
                x = tb(x.transpose(1, 2).reshape(b * k, s, d)).reshape(b, k, s, d)
                x = x.transpose(1, 2)
            out = self.head(x)
        return out.float()
