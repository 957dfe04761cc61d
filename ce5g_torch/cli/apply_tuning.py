"""Apply the phase-9 hyperparameter-search winner: retrain + evaluate.

Port of scripts/apply_tuning.py. Reference anchor:
run_phase9_hyperparameter_tuning.py treats the sorted search results as
the deliverable; this closes the loop: the winner is retrained at full
budget and evaluated on the test split as ``cnn_tuned``, so the study
answers "did the search move the number?".

    python -m ce5g_torch.cli.apply_tuning --data-dir DIR --model-dir DIR --results-dir DIR
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict

from ..config import ExperimentConfig
from ..eval import ModelEvaluator
from ..train import ChannelDataset, Trainer
from ._common import load_cfg, make_parser, parse, split_path


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--model-dir", required=True,
                        help="directory for the retrained winner's checkpoints")
    parser.add_argument("--results-dir", required=True,
                        help="directory for <name>_test_results.json")
    parser.add_argument(
        "--tuning-results", default=None,
        help="search results JSON (default <results-dir>/random_search_results.json)",
    )
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--name", default="cnn_tuned")
    return parser


def winner_config(cfg: ExperimentConfig, best: Dict, epochs: int) -> ExperimentConfig:
    """``cfg`` with the cnn and the optimizer of the search's winner."""
    model = dataclasses.replace(
        cfg.model,
        type="cnn",
        cnn_hidden_channels=tuple(best.get("hidden_channels", cfg.model.cnn_hidden_channels)),
        cnn_kernel_size=int(best.get("kernel_size", cfg.model.cnn_kernel_size)),
        cnn_dropout=float(best.get("dropout", cfg.model.cnn_dropout)),
    )
    training = dataclasses.replace(
        cfg.training,
        learning_rate=float(best.get("learning_rate", cfg.training.learning_rate)),
        batch_size=int(best.get("batch_size", cfg.training.batch_size)),
        weight_decay=float(best.get("weight_decay", cfg.training.weight_decay)),
        epochs=epochs,
    )
    return dataclasses.replace(cfg, model=model, training=training)


def main(argv=None) -> int:
    args, dev = parse(build_parser(), argv)
    cfg = load_cfg(args)
    rd = Path(args.results_dir)
    tr_path = Path(args.tuning_results or rd / "random_search_results.json")
    results = json.loads(tr_path.read_text())
    best = results[0]["params"]
    print(f"winner (val {results[0]['val_loss']:.6f}): {best}")
    cfg = winner_config(cfg, best, args.epochs)

    train_ds = ChannelDataset(split_path(args.data_dir, "train"))
    val_ds = ChannelDataset(split_path(args.data_dir, "val"))
    trainer = Trainer(cfg, model_type="cnn", name=args.name, device=dev)
    result = trainer.train(train_ds, val_ds, model_dir=args.model_dir)
    print(f"best val loss: {result['best_val_loss']:.6f} "
          f"({result['epochs_run']} epochs)")

    test_ds = ChannelDataset(split_path(args.data_dir, "test"))
    ev = ModelEvaluator(cfg, args.model_dir, results_dir=args.results_dir, device=dev)
    r = ev.evaluate_model(args.name, test_ds)
    r.pop("per_sample_nmse", None)
    r["tuning_winner"] = best
    print(r)
    ev.save_results(r, f"{args.name}_test_results.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
