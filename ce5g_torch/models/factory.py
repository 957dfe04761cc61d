"""Model factory (reference get_model, src/ai_models.py:327-375) and
parameter counting (reference utils.py:210-213). Port of
``ce5g_tpu.models.factory``."""
from __future__ import annotations

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
    dtype; parameters are float32. The initial weights come from ``seed``
    (torch's initialisers, not flax's: load a checkpoint for the JAX
    package's weights)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = _build(model_type.lower(), cfg, dtype)
    return model.to(dev).eval()


def count_parameters(model: nn.Module) -> int:
    """Trainable parameter count (reference utils.py:210-213): BatchNorm
    statistics and the LSTMs' frozen zero input biases are not counted."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
