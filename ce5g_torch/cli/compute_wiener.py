"""Precompute full-Wiener (mmse_full) estimates as dataset sidecars.

Port of scripts/compute_wiener.py: for every sample of a generated split,
run the full-Wiener estimator on the card and store the first antenna
pair's Ĥ_w[s, k] as ``H_wiener`` sidecar chunks + a
``<split>_<tag>_manifest.json`` (``data.wiener``), next to the split.
``train.ChannelDataset(wiener=True)`` (or ``wiener="bwiener"``) then emits
7-channel inputs for residual-on-Wiener training.

    python -m ce5g_torch.cli.compute_wiener --data-dir DIR [--estimator mmse_full_est]
"""
from __future__ import annotations

from pathlib import Path

from ..data import compute_wiener_sidecar
from ._common import load_cfg, make_parser, parse


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--data-dir", required=True,
                        help="the split's directory; the sidecars are written into it")
    parser.add_argument("--splits", nargs="*", default=["train", "val", "test"])
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument(
        "--estimator", default="mmse_full",
        choices=["mmse_full", "mmse_full_est"],
        help="'mmse_full' = oracle priors (default); 'mmse_full_est' = "
        "BLIND priors estimated from each frame (estimators/blind.py)",
    )
    parser.add_argument(
        "--tag", default=None,
        help="sidecar file tag (default: 'wiener' for mmse_full, "
        "'bwiener' for mmse_full_est)",
    )
    return parser


def main(argv=None) -> int:
    args, dev = parse(build_parser(), argv)
    cfg = load_cfg(args)
    tag = args.tag or ("bwiener" if args.estimator == "mmse_full_est" else "wiener")
    for split in args.splits:
        mp = Path(args.data_dir) / f"{split}_manifest.json"
        if not mp.exists():
            print(f"{split}: no manifest at {mp}, skipping")
            continue
        wm = compute_wiener_sidecar(
            cfg, mp, args.batch_size, estimator=args.estimator, tag=tag, device=dev
        )
        print(
            f"{split}: {tag} sidecar complete "
            f"({wm['samples_per_second']:.1f} samples/s)"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
