"""Hyperparameter search CLI (reference run_phase9_hyperparameter_tuning.py).

Port of scripts/tune_hyperparameters.py: each trial trains the cnn on a
quick subsample of the train split and scores it on one of the val split
(``eval.HyperparameterTuner``); the sorted trials are written to
``<results-dir>/random_search_results.json`` (or ``grid_search_results.json``).

    python -m ce5g_torch.cli.tune_hyperparameters --data-dir DIR --results-dir DIR [--trials N]
"""
from __future__ import annotations

from ..eval import HyperparameterTuner
from ..train import ChannelDataset
from ._common import load_cfg, make_parser, parse, split_path


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--results-dir", required=True,
                        help="directory for the search results and the trials' checkpoints")
    parser.add_argument("--mode", choices=["grid", "random"], default="random")
    parser.add_argument("--trials", type=int, default=10)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--quick-train", type=int, default=2000)
    parser.add_argument("--quick-val", type=int, default=500)
    return parser


def main(argv=None) -> int:
    args, dev = parse(build_parser(), argv)
    cfg = load_cfg(args)
    tuner = HyperparameterTuner(
        cfg,
        ChannelDataset(split_path(args.data_dir, "train")),
        ChannelDataset(split_path(args.data_dir, "val")),
        args.results_dir,
        quick_train=args.quick_train,
        quick_val=args.quick_val,
        epochs_per_trial=args.epochs,
        device=dev,
    )
    if args.mode == "grid":
        results = tuner.grid_search(max_trials=args.trials)
    else:
        results = tuner.random_search(num_trials=args.trials)
    best = results[0]
    print(f"best: val {best['val_loss']:.6f} with {best['params']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
