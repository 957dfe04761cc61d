"""Pilot-density sweep CLI (reference run_phase8_pilot_optimization.py).

Port of scripts/pilot_optimization.py. --models adds the phase-8 core
comparison the reference runs: trained models next to the classical
estimators across densities (run_phase8_pilot_optimization.py:113-160),
with slice-basis NMSE and measured QPSK BER per cell, plus an
identifiable-regime (SIMO config) BER sweep where BER actually falls with
SNR (the 2×2 BER floor is a superposition artifact, see
results/PLATEAU_DIAGNOSIS.md).

    python -m ce5g_torch.cli.pilot_optimization --results-dir DIR [--models cnn cnn_wiener]
"""
from __future__ import annotations

from ..config import load_config
from ..eval import PilotOptimizer, ber_sweep
from ..train import ChannelDataset
from ._common import load_cfg, make_parser, parse, split_path

BER_SNRS = (0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0)
BER_ESTIMATORS = ("ls", "mmse_full", "mmse_full_est")


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--densities", nargs="*", type=float,
                        default=[0.05, 0.08, 0.10, 0.12, 0.15])
    parser.add_argument("--model-densities", nargs="*", type=float,
                        default=[0.01, 0.02, 0.05, 0.08, 0.10])
    parser.add_argument("--snrs", nargs="*", type=float, default=[5, 10, 15, 20])
    parser.add_argument("--estimators", nargs="*", default=["ls", "mmse", "mmse_full"])
    parser.add_argument("--models", nargs="*", default=[],
                        help="trained models (e.g. cnn cnn_wiener) for the "
                        "phase-8 core comparison; needs --model-dir/--data-dir")
    parser.add_argument("--model-dir", default="models")
    parser.add_argument("--data-dir", default="data",
                        help="dataset whose stats normalized the models")
    parser.add_argument("--channel", default="EVA")
    parser.add_argument("--doppler", type=float, default=50.0)
    parser.add_argument("--frames", type=int, default=64)
    parser.add_argument("--simo-ber-config", default=None,
                        help="config for the identifiable-regime BER sweep "
                        "(e.g. configs/simo_identifiable.yaml); skipped if unset")
    parser.add_argument("--ber-frames", type=int, default=32,
                        help="frames a point of the identifiable-regime BER sweep")
    parser.add_argument("--results-dir", required=True,
                        help="directory for pilot_optimization_results.json")
    return parser


def main(argv=None) -> int:
    args, dev = parse(build_parser(), argv)
    cfg = load_cfg(args)
    opt = PilotOptimizer(cfg, args.results_dir, device=dev)
    res = opt.sweep(
        densities=args.densities,
        snrs_db=args.snrs,
        estimators=args.estimators,
        channel_type=args.channel,
        doppler_hz=args.doppler,
        frames_per_cell=args.frames,
    )

    if args.models:
        ds = ChannelDataset(split_path(args.data_dir, "test"))
        res["model_sweep"] = opt.model_sweep(
            args.models,
            args.model_dir,
            ds.stats,
            densities=args.model_densities,
            snrs_db=args.snrs,
            channel_type=args.channel,
            doppler_hz=args.doppler,
            frames_per_cell=args.frames,
        )

    if args.simo_ber_config:
        simo_cfg = load_config(args.simo_ber_config)
        res["ber_identifiable"] = {
            "note": "1×TX config — no superposition, so BER falls with SNR "
            "(contrast with the 2×2 BER floor above); density 5%, "
            "EVA, 50 Hz, QPSK, measured by full demodulation.",
            "ber_vs_snr": {
                est: ber_sweep(
                    simo_cfg, list(BER_SNRS), estimator=est, density=0.05,
                    frames_per_point=args.ber_frames, device=dev,
                )
                for est in BER_ESTIMATORS
            },
        }

    path = opt.save(res)
    for est, rec in res["recommendation"].items():
        print(f"{est}: best density {rec['best_density']:.0%}")
    if "model_sweep" in res:
        for name, rec in res["model_sweep"]["recommendation"].items():
            print(f"[model sweep] {name}: best density {rec['best_density']:.0%}")
    print(f"results → {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
