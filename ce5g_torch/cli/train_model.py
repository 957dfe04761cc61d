"""Model training CLI.

Port of scripts/train_model.py. Parity surface: reference src/train.py
main (:297-379), run_phase4_training.py (CNN) and
run_phase6_advanced_training.py (LSTM/Hybrid/ResNet):
--model/--epochs/--batch-size/--seed, best/final checkpoints, history
JSON, post-training test evaluation.

The split is resident on the card by default (``train.DeviceDataset``);
``--host-staging`` builds each batch on the host instead. ``--shard``
trains data parallel under ``torchrun``, one process per card
(``Trainer(mesh=...)``); rank 0 writes the checkpoints and evaluates.

    python -m ce5g_torch.cli.train_model --data-dir DIR --model-dir DIR [--evaluate --results-dir DIR]
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import torch.distributed as dist

from ..eval import ModelEvaluator
from ..train import ChannelDataset, Trainer, advanced_policy
from ._common import end_process_group, load_cfg, make_parser, parse, split_path, torchrun_mesh


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument(
        "--model",
        default="cnn",
        choices=["cnn", "lstm", "hybrid", "resnet", "transformer"],
    )
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--model-dir", required=True,
                        help="directory for the checkpoints and the history")
    parser.add_argument("--results-dir", default=None,
                        help="where --evaluate writes results (needed with --evaluate)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--loss", default=None,
                        choices=["mse", "mae", "huber", "nmse"],
                        help="override cfg.training.loss ('nmse' = per-sample "
                        "normalized MSE, matches the eval metric)")
    parser.add_argument("--lr-scheduler", default=None,
                        choices=["cosine", "step", "plateau", "warm_restarts"])
    parser.add_argument("--shard", action="store_true",
                        help="data parallel over torchrun's processes, one per card")
    parser.add_argument(
        "--host-staging", action="store_true",
        help="build each batch on the host instead of keeping the split on the card",
    )
    parser.add_argument(
        "--advanced", action="store_true",
        help="phase-6 per-model optimizer policy (warm restarts etc.)",
    )
    parser.add_argument(
        "--wiener", action="store_true",
        help="7-channel wiener-residual layout (needs compute_wiener "
        "sidecars); checkpoints saved as <model>_wiener_*",
    )
    parser.add_argument(
        "--wiener-tag", default="wiener",
        help="which sidecar to join: 'wiener' (oracle priors, default) or "
        "'bwiener' (blind priors); non-default tags suffix the run name "
        "(e.g. cnn_wiener_blind for --wiener-tag bwiener)",
    )
    parser.add_argument("--evaluate", action="store_true", help="evaluate on test split")
    parser.add_argument(
        "--resume", action="store_true",
        help="continue from <model-dir>/<model>_last (model+optimizer+epoch)",
    )
    return parser


def run_name(model: str, wiener: bool, wiener_tag: str) -> str:
    """The checkpoint prefix: cnn, cnn_wiener, cnn_wiener_blind (tag
    'bwiener') or cnn_wiener_<tag>."""
    name = model
    if wiener:
        name += "_wiener"
        if wiener_tag == "bwiener":
            name += "_blind"
        elif wiener_tag != "wiener":
            name += f"_{wiener_tag}"
    return name


def main(argv=None) -> int:
    parser = build_parser()
    args, dev = parse(parser, argv)
    if args.evaluate and args.results_dir is None:
        parser.error("--evaluate writes <results-dir>/<run>_test_results.json: give --results-dir")
    cfg = load_cfg(args)
    tr = cfg.training
    if args.epochs:
        tr = dataclasses.replace(tr, epochs=args.epochs)
    if args.batch_size:
        tr = dataclasses.replace(tr, batch_size=args.batch_size)
    if args.loss:
        tr = dataclasses.replace(tr, loss=args.loss)
    if args.lr_scheduler:
        tr = dataclasses.replace(tr, lr_scheduler=args.lr_scheduler)
    cfg = dataclasses.replace(cfg, training=tr)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.wiener:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, input_channels=7)
        )
    if args.advanced:
        cfg = advanced_policy(cfg, args.model)

    if not args.shard:
        _train(args, cfg, dev, None)
        return 0
    dev, mesh = torchrun_mesh(dev)
    try:
        _train(args, cfg, dev, mesh)
    finally:
        end_process_group()
    return 0


def _train(args, cfg, dev, mesh) -> None:
    wiener_arg = args.wiener_tag if args.wiener else False
    train_ds = ChannelDataset(split_path(args.data_dir, "train"), wiener=wiener_arg)
    val_ds = ChannelDataset(split_path(args.data_dir, "val"), wiener=wiener_arg)
    name = run_name(args.model, args.wiener, args.wiener_tag)
    trainer = Trainer(
        cfg, model_type=args.model, mesh=mesh, name=name,
        device_data=False if args.host_staging else None, device=dev,
    )
    if args.resume:
        last = Path(args.model_dir) / f"{name}_last"
        if last.exists():
            trainer.resume(last)
        else:
            print(f"no resumable checkpoint at {last}; starting fresh")
    result = trainer.train(train_ds, val_ds, model_dir=args.model_dir)
    print(f"best val loss: {result['best_val_loss']:.6f} "
          f"({result['epochs_run']} epochs)")

    if args.evaluate and (mesh is None or dist.get_rank() == 0):
        test_ds = ChannelDataset(split_path(args.data_dir, "test"), wiener=wiener_arg)
        ev = ModelEvaluator(cfg, args.model_dir, results_dir=args.results_dir, device=dev)
        r = ev.evaluate_model(name, test_ds)
        r.pop("per_sample_nmse", None)
        print(r)
        ev.save_results(r, f"{name}_test_results.json")


if __name__ == "__main__":
    raise SystemExit(main())
