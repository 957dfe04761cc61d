"""Hyperparameter search (grid and random) of the CNN.

Port of ``ce5g_tpu.eval.tuning`` (reference
run_phase9_hyperparameter_tuning.py:75-251): subsampled quick datasets
(2000 / 500), an ``itertools.product`` grid search and a random search
over lists (choices) and (low, high) tuples (ranges), each trial a short
``train.Trainer`` run, results sorted by validation loss and written as
JSON. The trial draws (``random.Random(seed)``) and the subsample
(``np.random.default_rng(seed).permutation``) are host Python and numpy,
so both packages draw the same trials and the same frames.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..config import ExperimentConfig
from ..device import resolve_device
from ..train.datasets import ChannelDataset
from ..train.trainer import Trainer

DEFAULT_CNN_SPACE = {
    # lists = categorical choices; tuples = (low, high) ranges for random
    "learning_rate": [3e-4, 1e-3, 3e-3],
    "dropout": [0.05, 0.1, 0.2],
    "kernel_size": [3, 5],
    "batch_size": [32, 64],
    "weight_decay": [0.0, 1e-5, 1e-4],
    "hidden_channels": [(32, 64, 32), (64, 128, 64), (64, 128, 256, 128, 64)],
}


class QuickDataset(ChannelDataset):
    """A random subsample of a dataset (reference QuickDataset :33-72):
    ``max_samples`` frames of ``default_rng(seed).permutation``, in index
    order, with the base's normalisation stats (of the whole split) and
    its Wiener state, so ``make_batch`` and ``train.DeviceDataset`` read it
    as they read the base."""

    def __init__(self, base: ChannelDataset, max_samples: int, seed: int = 0):
        idx = np.random.default_rng(seed).permutation(len(base))[:max_samples]
        self.arrays = {k: v[np.sort(idx)] for k, v in base.arrays.items()}
        self.normalize = base.normalize
        self.stats = base.stats
        self.wiener = base.wiener


def _apply_trial(cfg: ExperimentConfig, trial: Dict[str, Any], epochs: int) -> ExperimentConfig:
    model = dataclasses.replace(
        cfg.model,
        type="cnn",
        cnn_hidden_channels=tuple(trial.get("hidden_channels", cfg.model.cnn_hidden_channels)),
        cnn_kernel_size=trial.get("kernel_size", cfg.model.cnn_kernel_size),
        cnn_dropout=trial.get("dropout", cfg.model.cnn_dropout),
    )
    training = dataclasses.replace(
        cfg.training,
        learning_rate=trial.get("learning_rate", cfg.training.learning_rate),
        batch_size=trial.get("batch_size", cfg.training.batch_size),
        weight_decay=trial.get("weight_decay", cfg.training.weight_decay),
        epochs=epochs,
        early_stopping=False,
        save_best=False,
        save_freq=10**9,
    )
    return dataclasses.replace(cfg, model=model, training=training)


def draw_random_trials(num_trials: int, space: Optional[Dict] = None,
                       seed: int = 0) -> List[Dict[str, Any]]:
    """The trials :meth:`HyperparameterTuner.random_search` runs, in the
    order drawn: per trial, per name in ``space``'s order, ``uniform`` or
    ``randint`` for a (low, high) numeric tuple, else ``choice``."""
    space = space or DEFAULT_CNN_SPACE
    rng = random.Random(seed)
    trials = []
    for _ in range(num_trials):
        trial = {}
        for name, choices in space.items():
            if isinstance(choices, tuple) and len(choices) == 2 and all(
                isinstance(c, (int, float)) and not isinstance(c, bool) for c in choices
            ):
                lo, hi = choices
                trial[name] = (
                    rng.uniform(lo, hi)
                    if isinstance(lo, float) or isinstance(hi, float)
                    else rng.randint(lo, hi)
                )
            else:
                trial[name] = rng.choice(list(choices))
        trials.append(trial)
    return trials


class HyperparameterTuner:
    def __init__(
        self,
        cfg: ExperimentConfig,
        train_ds: ChannelDataset,
        val_ds: ChannelDataset,
        results_dir: str,
        quick_train: int = 2000,
        quick_val: int = 500,
        epochs_per_trial: int = 5,
        log=print,
        device="cuda",
    ):
        """Trials train on ``device`` and write into ``results_dir``: the
        sorted results, and each trial's checkpoints under ``tuning_tmp``.
        It has no default, so the JAX package's ``results/`` is never
        written by accident."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_ds = QuickDataset(train_ds, quick_train, cfg.seed)
        self.val_ds = QuickDataset(val_ds, quick_val, cfg.seed)
        self.epochs = epochs_per_trial
        self.results_dir = Path(results_dir)
        self.results_dir.mkdir(parents=True, exist_ok=True)
        self.log = log

    def _run_trial(self, trial: Dict[str, Any]) -> Dict:
        cfg = _apply_trial(self.cfg, trial, self.epochs)
        trainer = Trainer(cfg, model_type="cnn", log=lambda *_: None, device=self.device)
        result = trainer.train(self.train_ds, self.val_ds, epochs=self.epochs,
                               model_dir=str(self.results_dir / "tuning_tmp"))
        return {"params": trial, "val_loss": result["best_val_loss"]}

    def grid_search(
        self, space: Optional[Dict[str, Sequence]] = None, max_trials: Optional[int] = None
    ) -> List[Dict]:
        space = space or {k: v for k, v in DEFAULT_CNN_SPACE.items() if isinstance(v, list)}
        names = list(space)
        combos = list(itertools.product(*[space[n] for n in names]))
        if max_trials:
            combos = combos[:max_trials]
        results = []
        for i, combo in enumerate(combos):
            trial = dict(zip(names, combo))
            r = self._run_trial(trial)
            results.append(r)
            self.log(f"grid {i + 1}/{len(combos)}: val {r['val_loss']:.6f} {trial}")
        return self._finish(results, "grid_search_results.json")

    def random_search(
        self, num_trials: int = 10, space: Optional[Dict] = None, seed: int = 0
    ) -> List[Dict]:
        trials = draw_random_trials(num_trials, space, seed)
        results = []
        for i, trial in enumerate(trials):
            r = self._run_trial(trial)
            results.append(r)
            self.log(f"random {i + 1}/{num_trials}: val {r['val_loss']:.6f} {trial}")
        return self._finish(results, "random_search_results.json")

    def _finish(self, results: List[Dict], name: str) -> List[Dict]:
        results.sort(key=lambda r: r["val_loss"])
        (self.results_dir / name).write_text(json.dumps(results, indent=2, default=str))
        return results
