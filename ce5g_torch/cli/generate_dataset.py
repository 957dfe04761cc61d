"""Dataset generation CLI.

Port of scripts/generate_dataset.py. Parity surface: reference
src/dataset_generator.py main (:230-315) + run_phase3_robust.py (chunked,
--resume, merge): splits, sample counts, npz output, seed control.

With ``--shard`` it runs under ``torchrun``, one process per card: each
rank writes its contiguous block of chunks (``DatasetGenerator``'s
writers default to the rank and world size), then after a barrier rank 0
assembles the global manifest, merges and verifies.

    python -m ce5g_torch.cli.generate_dataset --output-dir DIR [--format ce5g] [--verify]
    torchrun --nproc-per-node 4 -m ce5g_torch.cli.generate_dataset --shard --output-dir DIR
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

from ..data import DatasetGenerator, verify_dataset
from ._common import end_process_group, load_cfg, make_parser, parse, torchrun_mesh


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--output-dir", required=True, help="directory for the split files")
    parser.add_argument("--train-samples", type=int, default=None)
    parser.add_argument("--val-samples", type=int, default=None)
    parser.add_argument("--test-samples", type=int, default=None)
    parser.add_argument("--chunk-size", type=int, default=None)
    parser.add_argument(
        "--format",
        choices=("npz", "h5", "ce5g"),
        default=None,
        help="chunk file format; 'ce5g' uses the native threaded codec",
    )
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--resume", action="store_true", default=True)
    parser.add_argument("--no-resume", dest="resume", action="store_false")
    parser.add_argument("--merge", action="store_true", help="merge chunks per split")
    parser.add_argument("--verify", action="store_true", help="verify after generation")
    parser.add_argument(
        "--shard", action="store_true",
        help="one writer per torchrun process, one process per card",
    )
    return parser


def main(argv=None) -> int:
    args, dev = parse(build_parser(), argv)
    cfg = load_cfg(args)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.chunk_size is not None:
        cfg = dataclasses.replace(
            cfg, dataset=dataclasses.replace(cfg.dataset, chunk_size=args.chunk_size)
        )
    if args.format is not None:
        cfg = dataclasses.replace(
            cfg, dataset=dataclasses.replace(cfg.dataset, save_format=args.format)
        )
    if not args.shard:
        _generate(args, cfg, dev)
        return 0
    dev, _ = torchrun_mesh(dev)
    try:
        _generate(args, cfg, dev)
    finally:
        end_process_group()
    return 0


def _count(flag, default):
    return default if flag is None else flag  # 0 is a valid "skip split"


def _generate(args, cfg, dev) -> None:
    gen = DatasetGenerator(cfg, args.output_dir, device=dev)
    counts = {
        "train": _count(args.train_samples, cfg.dataset.train_samples),
        "val": _count(args.val_samples, cfg.dataset.val_samples),
        "test": _count(args.test_samples, cfg.dataset.test_samples),
    }
    group = dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if group else (0, 1)
    for split, n in counts.items():
        if n <= 0:
            continue
        manifest = gen.generate_split(split, n, resume=args.resume)
        print(f"{split}: {manifest['completed']} samples "
              f"@ {manifest['samples_per_second']:.1f}/s")
        if world > 1:
            dist.barrier()
            if rank == 0:
                gen.write_global_manifest(split, world)
            dist.barrier()
        if rank != 0:
            continue
        if args.merge:
            print(f"merged → {gen.merge_split(split)}")
        if args.verify:
            report = verify_dataset(f"{args.output_dir}/{split}_manifest.json")
            print(f"verify {split}: {'PASS' if report['passed'] else 'FAIL'}")


if __name__ == "__main__":
    raise SystemExit(main())
