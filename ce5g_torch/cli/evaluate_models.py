"""Evaluation CLI: baselines vs trained models + SNR sweep + report.

Port of scripts/evaluate_models.py. Parity surface: reference
run_phase5_evaluation.py main (:389-496). The checkpoints are the JAX
package's committed ones (or the port's own), loaded into the port's
models.

    python -m ce5g_torch.cli.evaluate_models --data-dir DIR --results-dir DIR [--models cnn ...]
"""
from __future__ import annotations

from pathlib import Path

from ..eval import (
    ModelEvaluator,
    evaluate_baselines,
    evaluate_estimators,
    generate_evaluation_report,
    plot_comparison,
    plot_snr_sweep,
)
from ..train import ChannelDataset
from ._common import load_cfg, make_parser, parse, split_path


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--model-dir", default="models")
    parser.add_argument("--results-dir", required=True,
                        help="directory for the results, the report and the figures")
    parser.add_argument("--models", nargs="*", default=["cnn"])
    parser.add_argument("--num-samples", type=int, default=None)
    parser.add_argument("--snr-sweep", action="store_true")
    parser.add_argument("--no-plots", action="store_true")
    parser.add_argument(
        "--estimators", nargs="*", default=["ls", "mmse", "mmse_full"],
        help="real classical estimators to re-run and time on the test set "
        "(reference evaluate.py:60-80 latency parity); pass none to skip",
    )
    return parser


def main(argv=None) -> int:
    args, dev = parse(build_parser(), argv)
    cfg = load_cfg(args)
    # load the wiener sidecar when present: plain models slice it off,
    # *_wiener models need it (eval/evaluate.py evaluate_model)
    has_wiener = (Path(args.data_dir) / "test_wiener_manifest.json").exists()
    test_ds = ChannelDataset(split_path(args.data_dir, "test"), wiener=has_wiener)

    ev = ModelEvaluator(cfg, args.model_dir, args.results_dir, device=dev)
    results = evaluate_baselines(test_ds, args.num_samples)
    all_results = {"LS": results["LS"], "MMSE": results["MMSE"]}
    if args.estimators:
        full = evaluate_estimators(test_ds, cfg, args.estimators, args.num_samples, device=dev)
        for est, r in full.items():
            r = dict(r)
            r.pop("per_sample", None)
            all_results[est] = r
            print(f"{est}: NMSE {r['nmse_db']:.2f} dB, "
                  f"{r['latency_ms_per_sample']:.3f} ms/sample")
    for m in args.models:
        try:
            r = ev.evaluate_model(m, test_ds, args.num_samples)
        except FileNotFoundError:
            print(f"skipping {m}: no checkpoint in {args.model_dir}")
            continue
        r.pop("per_sample_nmse", None)
        all_results[m] = r
        print(f"{m}: NMSE {r['nmse_db']:.2f} dB, "
              f"{r['latency_ms_per_sample']:.3f} ms/sample")
    print(f"LS {all_results['LS']['nmse_db']:.2f} dB   "
          f"MMSE(simplified) {all_results['MMSE']['nmse_db']:.2f} dB")

    ev.save_results(all_results)
    rd = Path(args.results_dir)
    generate_evaluation_report(all_results, rd / "evaluation_report.md")
    if not args.no_plots:
        plot_comparison(all_results, rd / "comparison.png")

    if args.snr_sweep:
        sweep = ev.snr_sweep(test_ds, [m for m in args.models if m in all_results],
                             args.num_samples)
        ev.save_results(sweep, "snr_sweep_results.json")
        if not args.no_plots:
            plot_snr_sweep(sweep, rd / "nmse_vs_snr.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
