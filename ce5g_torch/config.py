"""Typed configuration for the PyTorch port.

The port's own copy of ``ce5g_tpu.config``: the same frozen dataclasses,
defaults and YAML schema (reference: configs/experiment_config.yaml), so
one YAML file configures both packages. Frozen dataclasses are hashable,
which lets the port cache per-config tables (``physics.simulate.table_for``).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class OFDMConfig:
    """OFDM numerology (reference: src/channel_simulator.py:17-24)."""

    fft_size: int = 1024
    cp_length: int = 72
    num_symbols: int = 14
    useful_subcarriers: int = 600
    subcarrier_spacing: float = 15000.0  # Hz

    @property
    def sampling_rate(self) -> float:
        return self.fft_size * self.subcarrier_spacing

    @property
    def samples_per_symbol(self) -> int:
        return self.fft_size + self.cp_length

    @property
    def num_used_subcarriers(self) -> int:
        """DC bin is removed (reference: channel_simulator.py:141-148)."""
        sc = self.useful_subcarriers
        dc = self.fft_size // 2
        lo, hi = dc - sc // 2, dc + sc // 2
        return hi - lo - (1 if lo <= dc < hi else 0)

    @property
    def symbol_duration(self) -> float:
        return self.samples_per_symbol / self.sampling_rate


@dataclasses.dataclass(frozen=True)
class MIMOConfig:
    """Antenna configuration (reference: src/channel_simulator.py:27-31)."""

    num_tx: int = 2
    num_rx: int = 2


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Channel model parameters (reference: experiment_config.yaml:17-21)."""

    models: Tuple[str, ...] = ("EPA", "EVA", "ETU")
    doppler_hz: Tuple[float, ...] = (10.0, 50.0, 100.0, 200.0)
    carrier_freq: float = 2.0e9
    max_delay_spread: float = 5.0e-6
    num_oscillators: int = 20  # Jakes sum-of-sinusoids count
    # 'overwrite' matches the reference's last-path-wins tap collisions
    # (channel_simulator.py:125); 'accumulate' is the physical option.
    tap_collision: str = "overwrite"


@dataclasses.dataclass(frozen=True)
class PilotConfig:
    """Pilot configuration (reference: experiment_config.yaml:24-27)."""

    density: Tuple[float, ...] = (0.01, 0.02, 0.05, 0.10)
    pattern: str = "scattered"
    interpolation: str = "linear"
    # Static upper bound on pilots per frame (for fixed-shape batching).
    max_density: float = 0.15


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """(reference: experiment_config.yaml:30-33)."""

    snr_range_db: Tuple[float, ...] = (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0)
    num_frames: int = 1000
    modulation: str = "QPSK"


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """(reference: experiment_config.yaml:36-42)."""

    train_samples: int = 50000
    val_samples: int = 5000
    test_samples: int = 10000
    save_format: str = "npz"
    normalize: bool = True
    augmentation: bool = False
    chunk_size: int = 512  # frames per shard file


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Per-architecture model configs (reference: experiment_config.yaml:45-67)."""

    type: str = "cnn"
    # CNN
    cnn_hidden_channels: Tuple[int, ...] = (64, 128, 256, 128, 64)
    cnn_kernel_size: int = 3
    cnn_dropout: float = 0.1
    # LSTM
    lstm_hidden_size: int = 256
    lstm_num_layers: int = 3
    lstm_bidirectional: bool = True
    lstm_dropout: float = 0.2
    # Hybrid
    hybrid_cnn_channels: Tuple[int, ...] = (32, 64, 128)
    hybrid_lstm_hidden: int = 256
    hybrid_lstm_layers: int = 2
    # ResNet
    resnet_base_channels: int = 64
    resnet_num_blocks: int = 4
    input_channels: int = 5


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """(reference: experiment_config.yaml:70-94)."""

    epochs: int = 100
    batch_size: int = 64
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # adam | adamw | sgd
    lr_scheduler: str = "cosine"  # cosine | step | plateau | warm_restarts
    weight_decay: float = 1e-5
    gradient_clip: float = 1.0
    loss: str = "mse"  # mse | mae | huber
    channel_weight: float = 1.0
    pilot_weight: float = 0.0
    early_stopping: bool = True
    patience: int = 15
    min_delta: float = 1e-4
    save_best: bool = True
    save_freq: int = 5
    mixed_precision: bool = True


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Root config mirroring the reference YAML layout."""

    ofdm: OFDMConfig = OFDMConfig()
    mimo: MIMOConfig = MIMOConfig()
    channel: ChannelConfig = ChannelConfig()
    pilots: PilotConfig = PilotConfig()
    simulation: SimulationConfig = SimulationConfig()
    dataset: DatasetConfig = DatasetConfig()
    model: ModelConfig = ModelConfig()
    training: TrainingConfig = TrainingConfig()
    seed: int = 42
    data_dir: str = "./data"
    model_dir: str = "./models"
    results_dir: str = "./results"
    log_dir: str = "./logs"


def _tuple(x: Any) -> Any:
    return tuple(x) if isinstance(x, (list, tuple)) else x


def load_config(path: Optional[str] = None) -> ExperimentConfig:
    """Load an :class:`ExperimentConfig` from a YAML file.

    Accepts the reference's YAML schema (configs/experiment_config.yaml) and
    this package's flat overrides. Missing fields fall back to defaults.
    """
    if path is None:
        return ExperimentConfig()
    import yaml  # only YAML loading needs it

    raw: Dict[str, Any] = yaml.safe_load(Path(path).read_text()) or {}
    return config_from_dict(raw)


def config_from_dict(raw: Dict[str, Any]) -> ExperimentConfig:
    """Build an ExperimentConfig from a (reference-schema) nested dict."""
    ofdm = raw.get("ofdm", {})
    mimo = raw.get("mimo", {})
    chan = raw.get("channel", {})
    pil = raw.get("pilots", {})
    sim = raw.get("simulation", {})
    ds = raw.get("dataset", {})
    mdl = raw.get("model", {})
    tr = raw.get("training", {})
    paths = raw.get("paths", {})

    cnn = mdl.get("cnn", {})
    lstm = mdl.get("lstm", {})
    hybrid = mdl.get("hybrid", {})
    es = tr.get("early_stopping", {})
    ckpt = tr.get("checkpoint", {})
    lw = tr.get("loss_weights", {})

    return ExperimentConfig(
        ofdm=OFDMConfig(
            fft_size=ofdm.get("fft_size", 1024),
            cp_length=ofdm.get("cp_length", 72),
            num_symbols=ofdm.get("num_symbols", 14),
            useful_subcarriers=ofdm.get("useful_subcarriers", 600),
            subcarrier_spacing=float(ofdm.get("subcarrier_spacing", 15000.0)),
        ),
        mimo=MIMOConfig(
            num_tx=mimo.get("num_tx_antennas", mimo.get("num_tx", 2)),
            num_rx=mimo.get("num_rx_antennas", mimo.get("num_rx", 2)),
        ),
        channel=ChannelConfig(
            models=_tuple(chan.get("models", ("EPA", "EVA", "ETU"))),
            doppler_hz=_tuple(chan.get("doppler_hz", (10.0, 50.0, 100.0, 200.0))),
            carrier_freq=float(chan.get("carrier_freq", 2.0e9)),
            max_delay_spread=float(chan.get("max_delay_spread", 5.0e-6)),
        ),
        pilots=PilotConfig(
            density=_tuple(pil.get("density", (0.01, 0.02, 0.05, 0.10))),
            pattern=pil.get("pattern", "scattered"),
            interpolation=pil.get("interpolation", "linear"),
        ),
        simulation=SimulationConfig(
            snr_range_db=_tuple(sim.get("snr_range", (-5, 0, 5, 10, 15, 20, 25, 30))),
            num_frames=sim.get("num_frames", 1000),
            modulation=sim.get("modulation", "QPSK"),
        ),
        dataset=DatasetConfig(
            train_samples=ds.get("train_samples", 50000),
            val_samples=ds.get("val_samples", 5000),
            test_samples=ds.get("test_samples", 10000),
            save_format=ds.get("save_format", "npz"),
            normalize=ds.get("normalize", True),
            augmentation=ds.get("augmentation", False),
        ),
        model=ModelConfig(
            type=mdl.get("type", "CNN").lower(),
            cnn_hidden_channels=_tuple(cnn.get("hidden_channels", (64, 128, 256, 128, 64))),
            cnn_kernel_size=cnn.get("kernel_size", 3),
            cnn_dropout=cnn.get("dropout", 0.1),
            lstm_hidden_size=lstm.get("hidden_size", 256),
            lstm_num_layers=lstm.get("num_layers", 3),
            lstm_bidirectional=lstm.get("bidirectional", True),
            lstm_dropout=lstm.get("dropout", 0.2),
            hybrid_cnn_channels=_tuple(hybrid.get("cnn_channels", (32, 64, 128))),
            hybrid_lstm_hidden=hybrid.get("lstm_hidden", 256),
            hybrid_lstm_layers=hybrid.get("lstm_layers", 2),
        ),
        training=TrainingConfig(
            epochs=tr.get("epochs", 100),
            batch_size=tr.get("batch_size", 64),
            learning_rate=float(tr.get("learning_rate", 1e-3)),
            optimizer=tr.get("optimizer", "adam"),
            lr_scheduler=tr.get("lr_scheduler", "cosine"),
            weight_decay=float(tr.get("weight_decay", 1e-5)),
            gradient_clip=float(tr.get("gradient_clip", 1.0)),
            loss=tr.get("loss", "mse"),
            channel_weight=float(lw.get("channel_mse", 1.0)),
            pilot_weight=float(lw.get("ber_penalty", 0.0)),
            early_stopping=es.get("enabled", True),
            patience=es.get("patience", 15),
            min_delta=float(es.get("min_delta", 1e-4)),
            save_best=ckpt.get("save_best", True),
            save_freq=ckpt.get("save_freq", 5),
            mixed_precision=raw.get("compute", {}).get("mixed_precision", True),
        ),
        seed=raw.get("seed", 42),
        data_dir=paths.get("data_dir", "./data"),
        model_dir=paths.get("model_dir", "./models"),
        results_dir=paths.get("results_dir", "./results"),
        log_dir=paths.get("log_dir", "./logs"),
    )
