"""ce5g_torch — the PyTorch/CUDA port of ``ce5g_tpu``.

Simulates 3GPP EPA/EVA/ETU Jakes-fading MIMO-OFDM frames and estimates
the channel with LS, diagonal MMSE and the full Wiener MMSE (with true
priors, or blind: ``estimators.blind``), on an NVIDIA H100, with
hand-written CUDA kernels (``csrc/``) where the JAX package has Pallas
kernels; writes and verifies datasets (``data``: chunk files, Wiener
sidecars, digest manifests) and trains on frames that never leave the
card (``data.online_train``); trains (``train.Trainer``) and serves
(``models``, ``train.checkpoint``, ``eval.evaluate``) the learned
estimators; and runs the evaluation studies (``eval``: measured BER, the
pilot-density study, the hyperparameter search, the reports).
``ce5g_tpu`` stays the reference the port is tested against; this package
imports neither JAX nor ``ce5g_tpu``.

Entry points take ``device=`` (default ``"cuda"``) and raise without a
card unless the caller passes ``device="cpu"``.
"""

from .config import (
    ChannelConfig,
    DatasetConfig,
    ExperimentConfig,
    MIMOConfig,
    ModelConfig,
    OFDMConfig,
    PilotConfig,
    SimulationConfig,
    TrainingConfig,
    config_from_dict,
    load_config,
)

__version__ = "0.1.0"

__all__ = [
    "ChannelConfig",
    "DatasetConfig",
    "ExperimentConfig",
    "MIMOConfig",
    "ModelConfig",
    "OFDMConfig",
    "PilotConfig",
    "SimulationConfig",
    "TrainingConfig",
    "config_from_dict",
    "load_config",
]
