"""Model factory (reference get_model, src/ai_models.py:327-375) and
parameter counting (reference utils.py:210-213). Port of
``ce5g_tpu.models.factory``."""
from __future__ import annotations

import math

import torch
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from .cnn import CNNChannelEstimator
from .hybrid import HybridCNNLSTMEstimator
from .lstm import LSTMChannelEstimator
from .resnet import ResNetChannelEstimator
from .transformer import TransformerChannelEstimator

MODEL_TYPES = ("cnn", "lstm", "hybrid", "cnn_lstm", "resnet", "transformer")


def _build(mt: str, cfg: ModelConfig, dtype: torch.dtype) -> nn.Module:
    if mt == "cnn":
        return CNNChannelEstimator(
            in_channels=cfg.input_channels,
            hidden_channels=cfg.cnn_hidden_channels,
            kernel_size=cfg.cnn_kernel_size,
            dropout=cfg.cnn_dropout,
            dtype=dtype,
        )
    if mt == "lstm":
        return LSTMChannelEstimator(
            in_features=4,
            hidden_size=cfg.lstm_hidden_size,
            num_layers=cfg.lstm_num_layers,
            bidirectional=cfg.lstm_bidirectional,
            dropout=cfg.lstm_dropout,
            dtype=dtype,
        )
    if mt in ("hybrid", "cnn_lstm"):
        return HybridCNNLSTMEstimator(
            in_channels=cfg.input_channels,
            cnn_channels=cfg.hybrid_cnn_channels,
            lstm_hidden=cfg.hybrid_lstm_hidden,
            lstm_layers=cfg.hybrid_lstm_layers,
            dropout=cfg.cnn_dropout,
            dtype=dtype,
        )
    if mt == "resnet":
        return ResNetChannelEstimator(
            in_channels=cfg.input_channels,
            base_channels=cfg.resnet_base_channels,
            num_blocks=cfg.resnet_num_blocks,
            dropout=cfg.cnn_dropout,
            dtype=dtype,
        )
    if mt == "transformer":
        return TransformerChannelEstimator(in_channels=cfg.input_channels, dtype=dtype)
    raise ValueError(f"Unknown model type: {mt!r} (choose from {MODEL_TYPES})")


#: flax's truncated normal divides the std by this, the std of a unit
#: normal truncated to ±2, so that the kept samples have the std asked for
_TRUNC_STD = 0.87962566103423978


def init_like_flax(model: nn.Module) -> nn.Module:
    """Re-draw ``model``'s parameters from the families flax gives the JAX
    models by default, in place, from torch's global generator:

    * Conv and Linear (attention projections included): ``lecun_normal``
      kernels, a normal truncated to ±2σ with variance 1/fan_in, and zero
      biases;
    * LSTM: ``lecun_normal`` input kernels, ``orthogonal`` recurrent
      kernels and zero biases. flax draws ``dense_h``'s kernel as one
      (H, 4H) matrix with orthonormal rows, so torch's (4H, H)
      ``weight_hh`` is drawn as one matrix with orthonormal columns, not
      as four (H, H) blocks;
    * BatchNorm and LayerNorm: unit scales, zero biases and statistics
      (torch's own);
    * the transformer's position tables keep their ``normal(0.02)``.
    """
    def lecun_normal_(w: torch.Tensor) -> None:
        std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD  # fan_in = in · kh · kw
        nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std)

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                lecun_normal_(module.weight)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LSTM):
                for name, p in module.named_parameters():
                    if name.startswith("weight_ih"):
                        lecun_normal_(p)
                    elif name.startswith("weight_hh"):
                        nn.init.orthogonal_(p)
                    else:
                        p.zero_()
    return model


def get_model(
    model_type: str,
    cfg: ModelConfig,
    *,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    device="cuda",
) -> nn.Module:
    """Build a model by name on ``device``, in eval mode. 'cnn_lstm'
    aliases 'hybrid' (reference ai_models.py:349). ``dtype`` is the compute
    dtype; parameters are float32. The initial weights are drawn from
    ``seed`` with the JAX models' initialisers (:func:`init_like_flax`):
    the same distributions, not the same numbers."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = init_like_flax(_build(model_type.lower(), cfg, dtype))
    return model.to(dev).eval()


def count_parameters(model: nn.Module) -> int:
    """Trainable parameter count (reference utils.py:210-213): BatchNorm
    statistics and the LSTMs' frozen zero input biases are not counted."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
