"""Training loop: optimizers and per-epoch schedules, the train step, early
stopping, checkpoints and metric logs. Port of ``ce5g_tpu.train.trainer``
(reference src/train.py:97-294, run_phase4_training.py:115-266,
run_phase6_advanced_training.py:125-288):

  * optimizers adam | adamw (both optax's decoupled ``adamw``, so torch's
    ``AdamW``) | sgd (momentum 0.9, no weight decay);
  * per-EPOCH schedules: cosine (T_max = epochs), step (30, γ = 0.1),
    plateau (patience 10, factor 0.1), warm_restarts (T_0 = 10, T_mult = 2);
  * gradient clipping by global norm as optax's ``clip_by_global_norm``;
    early stopping (patience / min_delta);
  * best, rolling-resumable, periodic and final checkpoints; per-epoch
    history (JSON) and scalars (JSONL).

The split lives on the card by default (``DeviceDataset``): each step
gathers its shuffled batch there by index, so no step moves data from the
host. PyTorch runs eagerly, so one per-step loop serves every family, the
recurrent ones included. The shuffle is the JAX package's,
``np.random.default_rng(seed + epoch).permutation(n)`` cut to whole
batches, so both packages see the same batches. With
``cfg.training.mixed_precision`` the model computes in bf16 (autocast,
float32 parameters) and the loss stays float32.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..config import ExperimentConfig
from ..device import resolve_device
from ..models.factory import count_parameters, get_model
from ..models.inputs import apply_output_residual
from ..models.loss import channel_estimation_loss
from .checkpoint import load_checkpoint, save_checkpoint
from .datasets import ChannelDataset, DeviceDataset


def lr_schedule_per_epoch(cfg: ExperimentConfig, epoch: int, lr_scale: float = 1.0) -> float:
    """torch-parity per-epoch LR value (plateau handled via ``lr_scale``)."""
    base = cfg.training.learning_rate
    sched = cfg.training.lr_scheduler
    if sched == "cosine":
        t = min(epoch, cfg.training.epochs) / max(cfg.training.epochs, 1)
        lr = base * 0.5 * (1 + math.cos(math.pi * t))
    elif sched == "step":
        lr = base * (0.1 ** (epoch // 30))
    elif sched == "warm_restarts":
        t0, t_mult = 10, 2
        e, period = epoch, t0
        while e >= period:
            e -= period
            period *= t_mult
        lr = base * 0.5 * (1 + math.cos(math.pi * e / period))
    else:  # plateau or none: constant base
        lr = base
    return lr * lr_scale


def make_optimizer(cfg: ExperimentConfig, params) -> torch.optim.Optimizer:
    """The optimizer of the JAX package's optax chain over ``params``. Its
    'adam' is optax's decoupled ``adamw``, so 'adam' and 'adamw' are both
    ``AdamW`` with the config's weight decay (never torch's default 0.01);
    'sgd' has momentum 0.9 and no weight decay, as optax's ``sgd``. The LR
    is set per epoch by the trainer; clipping is :func:`clip_by_global_norm_`."""
    tr = cfg.training
    if tr.optimizer in ("adam", "adamw"):
        return torch.optim.AdamW(params, lr=tr.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=tr.weight_decay)
    if tr.optimizer == "sgd":
        return torch.optim.SGD(params, lr=tr.learning_rate, momentum=0.9)
    raise ValueError(f"Unknown optimizer: {tr.optimizer!r}")


def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place on the gradients: unchanged
    while their global norm is below ``max_norm``, else scaled by
    max_norm/‖g‖ (``torch.nn.utils.clip_grad_norm_`` always scales, by
    max_norm/(‖g‖ + 1e-6)). No device synchronise."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


class Trainer:
    """Epoch-driven trainer (reference Trainer parity), on ``device``."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        model: Optional[nn.Module] = None,
        model_type: Optional[str] = None,
        log=print,
        tensorboard: bool = False,
        device_data: Optional[bool] = None,
        name: Optional[str] = None,
        device="cuda",
    ):
        """``device_data``: train from a split resident on the card
        (``DeviceDataset``, batches gathered there by index); None or True
        is that default, False stages every batch from the host.
        ``name`` prefixes the checkpoint and history files (default the
        model type; e.g. 'cnn_wiener' = the cnn on wiener features)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model_type = model_type or cfg.model.type
        self.name = name or self.model_type
        dtype = torch.bfloat16 if cfg.training.mixed_precision else torch.float32
        self.model = model or get_model(self.model_type, cfg.model, dtype=dtype, seed=cfg.seed,
                                        device=self.device)
        # frozen parameters (the LSTMs' zero input biases) stay out
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(cfg, self.params)
        self.log = log
        self.history: Dict[str, List[float]] = {
            "train_loss": [],
            "val_loss": [],
            "lr": [],
            "epoch_time": [],
        }
        self.best_val_loss = float("inf")
        self.epochs_without_improvement = 0
        self._lr_scale = 1.0
        self._plateau_wait = 0
        self._start_epoch = 0
        self._is_lstm = self.model_type == "lstm"
        self.device_data = device_data
        self._scalar_log: List[Dict] = []
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(Path(cfg.log_dir) / "tensorboard"))
            except ImportError:
                self.log("tensorboard unavailable; falling back to JSONL only")

    def _log_scalar(self, tag: str, step: int, value: float):
        self._scalar_log.append({"tag": tag, "step": step, "value": value})
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    # ---------------------------------------------------------------- steps
    def _layout(self, x, y):
        """The model's layout of a grid batch and the loss's pilot mask:
        the LSTM takes the flattened (B, S·K, 4) sequence and no mask."""
        if self._is_lstm:
            b, s, k, _ = x.shape
            return x[..., :4].reshape(b, s * k, 4), y.reshape(b, s * k, 2), None
        return x, y, x[..., 4]

    def _loss(self, x, y, m):
        tr = self.cfg.training
        pred = apply_output_residual(self.model(x), x)
        return channel_estimation_loss(pred, y, m, tr.loss, tr.channel_weight, tr.pilot_weight)

    def _step(self, x, y, m) -> torch.Tensor:
        """One optimizer step; the loss stays on the device."""
        loss = self._loss(x, y, m)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.cfg.training.gradient_clip > 0:
            clip_by_global_norm_(self.params, self.cfg.training.gradient_clip)
        self.optimizer.step()
        return loss.detach()

    def _set_lr(self, epoch: int) -> None:
        lr = lr_schedule_per_epoch(self.cfg, epoch, self._lr_scale)
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _epoch_losses(self, losses: List[torch.Tensor], epoch: int) -> float:
        """One fetch of the epoch's step losses; every tenth is logged."""
        if not losses:
            return 0.0
        vals = torch.stack(losses).float().cpu().numpy()
        for i in range(9, len(vals), 10):
            self._log_scalar("train/batch_loss", epoch * 10000 + i + 1, float(vals[i]))
        return float(vals.mean())

    def _host_batch(self, batch):
        x = torch.from_numpy(batch.inputs).to(self.device)
        y = torch.from_numpy(batch.targets).to(self.device)
        return self._layout(x, y)

    # ---------------------------------------------------------------- loop
    def train_epoch(self, dataset: ChannelDataset, epoch: int) -> float:
        """One epoch staging each batch from the host."""
        self._set_lr(epoch)
        self.model.train()
        losses = [
            self._step(*self._host_batch(batch))
            for batch in dataset.batches(self.cfg.training.batch_size, shuffle=True,
                                         seed=self.cfg.seed + epoch)
        ]
        return self._epoch_losses(losses, epoch)

    def validate(self, dataset: ChannelDataset) -> float:
        self.model.eval()
        with torch.no_grad():
            losses = [self._loss(*self._host_batch(batch))
                      for batch in dataset.batches(self.cfg.training.batch_size)]
        return float(torch.stack(losses).mean()) if losses else 0.0

    def _device_train_epoch(self, dd: DeviceDataset, epoch: int) -> float:
        """One epoch over a device-resident split, batches gathered on the
        card by index."""
        bsz = self.cfg.training.batch_size
        steps = len(dd) // bsz
        self._set_lr(epoch)
        self.model.train()
        perm = np.random.default_rng(self.cfg.seed + epoch).permutation(len(dd))
        idx2d = torch.as_tensor(perm[: steps * bsz].reshape(steps, bsz), device=self.device)
        losses = []
        for i in range(steps):
            idx = idx2d[i]
            losses.append(self._step(*self._layout(dd.inputs[idx], dd.targets[idx])))
        return self._epoch_losses(losses, epoch)

    def _device_validate(self, dd: DeviceDataset) -> float:
        bsz = self.cfg.training.batch_size
        steps = len(dd) // bsz
        if steps == 0:
            return 0.0
        self.model.eval()
        with torch.no_grad():
            losses = [self._loss(*self._layout(dd.inputs[i * bsz:(i + 1) * bsz],
                                               dd.targets[i * bsz:(i + 1) * bsz]))
                      for i in range(steps)]
        return float(torch.stack(losses).mean())

    def _plateau_update(self, val_loss: float):
        """torch ReduceLROnPlateau(mode=min, patience=10, factor=0.1)."""
        if self.cfg.training.lr_scheduler != "plateau":
            return
        if val_loss < self.best_val_loss - 1e-12:
            self._plateau_wait = 0
        else:
            self._plateau_wait += 1
            if self._plateau_wait > 10:
                self._lr_scale *= 0.1
                self._plateau_wait = 0

    def _trainer_meta(self, epoch: int, val_loss: float) -> Dict:
        """Everything needed to continue the loop exactly where it stopped:
        the epoch, the losses, and the scheduler and early-stop counters."""
        return {
            "epoch": epoch,
            "val_loss": val_loss,
            "best_val_loss": self.best_val_loss,
            "epochs_without_improvement": self.epochs_without_improvement,
            "lr_scale": self._lr_scale,
            "plateau_wait": self._plateau_wait,
            "history": self.history,
        }

    def resume(self, path) -> int:
        """Restore model, optimizer, generators and loop counters from a
        resumable checkpoint; return the epoch to continue from."""
        meta = load_checkpoint(path, self.model, self.optimizer)
        if "epoch" not in meta:
            raise ValueError(f"checkpoint {path} has no epoch metadata")
        self._start_epoch = int(meta["epoch"]) + 1
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        self.epochs_without_improvement = int(meta.get("epochs_without_improvement", 0))
        self._lr_scale = float(meta.get("lr_scale", 1.0))
        self._plateau_wait = int(meta.get("plateau_wait", 0))
        hist = meta.get("history")
        if hist:
            self.history = {k: list(v) for k, v in hist.items()}
        self.log(f"resumed from {path}: continuing at epoch {self._start_epoch + 1}")
        return self._start_epoch

    def train(self, train_ds, val_ds, epochs: Optional[int] = None,
              model_dir: Optional[str] = None) -> Dict:
        """Train from ``self._start_epoch`` to ``epochs``; ``train_ds`` and
        ``val_ds`` are ``ChannelDataset``s or ``DeviceDataset``s."""
        cfg = self.cfg
        epochs = cfg.training.epochs if epochs is None else epochs
        model_dir = Path(model_dir or cfg.model_dir)
        model_dir.mkdir(parents=True, exist_ok=True)
        self.log(
            f"Training {self.model_type}: {count_parameters(self.model):,} params, "
            f"{epochs} epochs, batch {cfg.training.batch_size}"
        )
        use_device = self.device_data is not False
        if use_device:
            t0 = time.perf_counter()
            dd_train, dd_val = (
                ds if isinstance(ds, DeviceDataset) else DeviceDataset(ds, device=self.device)
                for ds in (train_ds, val_ds)
            )
            self.log(f"device-resident data: {len(dd_train)}+{len(dd_val)} samples "
                     f"staged to {self.device} in {time.perf_counter() - t0:.1f}s")

        epoch, val_loss = self._start_epoch - 1, self.best_val_loss
        for epoch in range(self._start_epoch, epochs):
            t0 = time.perf_counter()
            if use_device:
                train_loss = self._device_train_epoch(dd_train, epoch)
                val_loss = self._device_validate(dd_val)
            else:
                train_loss = self.train_epoch(train_ds, epoch)
                val_loss = self.validate(val_ds)
            self._plateau_update(val_loss)
            dt = time.perf_counter() - t0
            lr = lr_schedule_per_epoch(cfg, epoch, self._lr_scale)
            self.history["train_loss"].append(train_loss)
            self.history["val_loss"].append(val_loss)
            self.history["lr"].append(lr)
            self.history["epoch_time"].append(dt)
            for tag, v in (("train/epoch_loss", train_loss), ("val/loss", val_loss),
                           ("train/lr", lr)):
                self._log_scalar(tag, epoch, v)
            self.log(f"epoch {epoch + 1}/{epochs}  train {train_loss:.6f}  "
                     f"val {val_loss:.6f}  lr {lr:.2e}  ({dt:.1f}s)")

            if val_loss < self.best_val_loss - cfg.training.min_delta:
                self.best_val_loss = val_loss
                self.epochs_without_improvement = 0
                if cfg.training.save_best:
                    save_checkpoint(model_dir / f"{self.name}_best", self.model,
                                    epoch=epoch, val_loss=val_loss)
            else:
                self.epochs_without_improvement += 1

            # rolling resumable checkpoint: a killed run continues from here
            # with the same trajectory
            save_checkpoint(model_dir / f"{self.name}_last", self.model, self.optimizer,
                            **self._trainer_meta(epoch, val_loss))
            if (epoch + 1) % cfg.training.save_freq == 0:
                save_checkpoint(model_dir / f"{self.name}_epoch_{epoch + 1}", self.model,
                                self.optimizer, **self._trainer_meta(epoch, val_loss))

            if (cfg.training.early_stopping
                    and self.epochs_without_improvement >= cfg.training.patience):
                self.log(f"Early stopping at epoch {epoch + 1}")
                break

        save_checkpoint(model_dir / f"{self.name}_final", self.model, epoch=epoch,
                        val_loss=val_loss)
        (model_dir / f"{self.name}_history.json").write_text(json.dumps(self.history, indent=2))
        (model_dir / f"{self.name}_scalars.jsonl").write_text(
            "\n".join(json.dumps(r) for r in self._scalar_log))
        if self._tb is not None:
            self._tb.close()
        return {
            "best_val_loss": self.best_val_loss,
            "epochs_run": len(self.history["train_loss"]),
            "history": self.history,
        }


def advanced_policy(cfg: ExperimentConfig, model_type: str) -> ExperimentConfig:
    """Per-model optimizer policy of the reference's AdvancedTrainer
    (run_phase6_advanced_training.py:138-160): LSTM → Adam at lr/2,
    Hybrid → AdamW with wd 1e-4, others → Adam; all with
    CosineAnnealingWarmRestarts(T_0=10, T_mult=2)."""
    tr = cfg.training
    if model_type == "lstm":
        tr = dataclasses.replace(tr, optimizer="adam", learning_rate=tr.learning_rate / 2)
    elif model_type in ("hybrid", "cnn_lstm"):
        tr = dataclasses.replace(tr, optimizer="adamw", weight_decay=1e-4)
    else:
        tr = dataclasses.replace(tr, optimizer="adam")
    tr = dataclasses.replace(tr, lr_scheduler="warm_restarts")
    return dataclasses.replace(cfg, training=tr)
