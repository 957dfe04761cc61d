"""Neural channel estimators, port of ``ce5g_tpu.models``: CNN, LSTM,
hybrid CNN+LSTM, ResNet and the axial Transformer. Grid models map NHWC
``(B, S, K, 5 or 7) → (B, S, K, 2)``; the LSTM maps ``(B, S·K, 4) →
(B, S·K, 2)``. ``convert.model_state_from_numpy`` fills them from the JAX
package's flat checkpoint arrays."""
from .cnn import BatchNorm, CNNChannelEstimator, ConvBlock
from .factory import MODEL_TYPES, count_parameters, get_model, init_like_flax
from .hybrid import HybridCNNLSTMEstimator
from .inputs import MLBatch, apply_output_residual, grid_inputs, lstm_inputs
from .loss import channel_estimation_loss
from .lstm import BiLSTMLayer, LSTMChannelEstimator
from .resnet import ResidualBlock, ResNetChannelEstimator
from .transformer import AxialBlock, TransformerChannelEstimator

__all__ = [
    "BatchNorm",
    "CNNChannelEstimator",
    "ConvBlock",
    "LSTMChannelEstimator",
    "BiLSTMLayer",
    "HybridCNNLSTMEstimator",
    "ResidualBlock",
    "ResNetChannelEstimator",
    "AxialBlock",
    "TransformerChannelEstimator",
    "MODEL_TYPES",
    "count_parameters",
    "get_model",
    "init_like_flax",
    "channel_estimation_loss",
    "MLBatch",
    "apply_output_residual",
    "grid_inputs",
    "lstm_inputs",
]
