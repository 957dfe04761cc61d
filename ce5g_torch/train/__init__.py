"""Datasets, checkpoints and the trainer of the port (``ce5g_tpu.train``)."""
from .checkpoint import load_checkpoint, save_checkpoint
from .datasets import ChannelDataset, DeviceDataset
from .trainer import Trainer, advanced_policy, lr_schedule_per_epoch, make_optimizer

__all__ = [
    "ChannelDataset",
    "DeviceDataset",
    "Trainer",
    "advanced_policy",
    "load_checkpoint",
    "lr_schedule_per_epoch",
    "make_optimizer",
    "save_checkpoint",
]
