"""Online (dataset-free) training CLI.

Port of scripts/train_online.py: the fused generate → train loop
(``data.online_train``). Every SGD step simulates a fresh batch on the
card from its own seeded generator and consumes it there: no dataset
files, no host I/O in the loop, data that never repeats. With
``--wiener-estimator mmse_full_est`` the 7-channel BLIND residual-on-
Wiener layout is computed in-step, so blind-residual training needs no
sidecar pipeline at all.

Example (the JAX package's blind-SIMO run, here into a new directory):
    python -m ce5g_torch.cli.train_online --config configs/simo_identifiable.yaml \\
        --model cnn --wiener-estimator mmse_full_est --loss nmse \\
        --samples 2097152 --batch 256 --stats-from data_simo \\
        --name cnn_wiener_blind_online --model-dir DIR
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from ..data import online_train
from ..train import ChannelDataset
from ._common import load_cfg, make_parser, parse, split_path


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--model", default="cnn")
    parser.add_argument("--samples", type=int, default=1048576)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--steps-per-dispatch", type=int, default=16)
    parser.add_argument("--wiener-estimator", default=None,
                        choices=[None, "mmse_full", "mmse_full_est"],
                        help="7-channel residual-on-Wiener layout with the "
                        "feature computed in-step (mmse_full_est = blind)")
    parser.add_argument("--loss", default=None,
                        help="override cfg.training.loss (e.g. nmse)")
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--lr-schedule", default="cosine",
                        choices=["constant", "cosine"])
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--stats-from", default=None,
                        help="data dir whose test split provides the "
                        "normalization stats (the same stats evaluation "
                        "uses); default: unit stats")
    parser.add_argument("--name", default=None,
                        help="checkpoint name (default <model>_online)")
    parser.add_argument("--model-dir", required=True,
                        help="directory for the checkpoint and the history")
    return parser


def main(argv=None) -> int:
    args, dev = parse(build_parser(), argv)
    cfg = load_cfg(args)
    if args.lr is not None:
        cfg = dataclasses.replace(
            cfg, training=dataclasses.replace(cfg.training, learning_rate=args.lr)
        )
    stats = None
    if args.stats_from:
        stats = ChannelDataset(split_path(args.stats_from, "test")).stats
        print(f"stats from {args.stats_from}: "
              + ", ".join(f"{k}={v:.4f}" for k, v in stats.items()))

    name = args.name or f"{args.model}_online"
    ckpt = Path(args.model_dir) / f"{name}_best"
    out = online_train(
        cfg,
        args.model,
        total_samples=args.samples,
        batch_size=args.batch,
        steps_per_dispatch=args.steps_per_dispatch,
        stats=stats,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        wiener_estimator=args.wiener_estimator,
        loss_type=args.loss,
        lr_schedule=args.lr_schedule,
        checkpoint_dir=str(ckpt),
        device=dev,
    )
    hist = Path(args.model_dir) / f"{name}_history.json"
    hist.write_text(json.dumps(out, indent=2))
    print(f"checkpoint → {ckpt}\nhistory → {hist}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
