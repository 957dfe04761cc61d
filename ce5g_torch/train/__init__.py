"""Datasets and checkpoints of the port (``ce5g_tpu.train``'s serving
half; the trainer comes with a later slice)."""
from .checkpoint import load_checkpoint, save_checkpoint
from .datasets import ChannelDataset

__all__ = ["ChannelDataset", "load_checkpoint", "save_checkpoint"]
