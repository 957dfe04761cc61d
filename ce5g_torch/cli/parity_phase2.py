"""Phase-2 classical-estimator parity study vs the reference's published
numbers (PHASE_2_BASELINE_ESTIMATORS.md:255-275, test_phase2_report.py:33-43).

Port of scripts/parity_phase2.py. Reproduces, with ``--frames`` i.i.d.
frames per cell instead of the reference's single draw:
  * LS(cubic) vs diag-MMSE(linear) comparison at SNR 5-25 (EVA, 10%);
  * the 12-cell interpolation study (nearest/linear/cubic);
  * a scipy.griddata cross-check of the port's interpolators.

Writes <results-dir>/parity_phase2.json and parity_phase2.md.

    python -m ce5g_torch.cli.parity_phase2 --results-dir DIR [--frames 64] [--skip-scipy]
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from ..eval.parity import REFERENCE_PHASE2, Phase2Parity, griddata_cross_check
from ._common import load_cfg, make_parser, parse


def markdown(out: Dict) -> str:
    """The study's markdown table, as scripts/parity_phase2.py writes it."""
    comp, interp, cross = out["comparison"], out["interpolation"], out["griddata_cross_check"]
    lines = [
        "# Phase-2 classical-estimator parity",
        "",
        f"Ours: {out['frames_per_cell']} frames/cell; reference: 1 frame/cell "
        "(sampling spread O(1 dB) absorbed by the comparison bound).",
        "",
        "## LS vs MMSE (EVA, 10% pilots, Doppler 50 Hz)",
        "",
        "| SNR (dB) | LS cubic (ours) | MMSE diag (ours) | MMSE full (ours) |",
        "|---|---|---|---|",
    ]
    for snr, row in comp["per_snr"].items():
        lines.append(
            f"| {snr} | {row['ls:cubic']:.2f} | {row['mmse:linear']:.2f} "
            f"| {row['mmse_full:linear']:.2f} |"
        )
    lines += [
        "",
        f"Average: LS {comp['avg_db']['ls:cubic']:.2f} dB "
        f"(reference 0.18), MMSE {comp['avg_db']['mmse:linear']:.2f} dB "
        f"(reference −0.98), mmse_full {comp['avg_db']['mmse_full:linear']:.2f} dB.",
        "",
        "## Interpolation study (12 cells)",
        "",
        "| Method | Avg NMSE ours (dB) | Avg NMSE reference (dB) | Wins |",
        "|---|---|---|---|",
    ]
    for m in ("nearest", "linear", "cubic"):
        lines.append(
            f"| {m} | {interp['avg_db'][m]:.2f} "
            f"| {interp['reference_avg_db'][m]:.2f} | {interp['wins'][m]}/12 |"
        )
    if cross:
        lines += [
            "",
            "## scipy.griddata cross-check (EVA, 15 dB, 10%)",
            "",
            "| Method | ours (dB) | scipy.griddata (dB) | Δ (dB) |",
            "|---|---|---|---|",
        ]
        for m, r in cross.items():
            lines.append(
                f"| {m} | {r['ours_db']:.2f} | {r['scipy_db']:.2f} "
                f"| {r['delta_db']:+.2f} |"
            )
    return "\n".join(lines) + "\n"


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--frames", type=int, default=64, help="frames per cell")
    parser.add_argument("--results-dir", required=True,
                        help="directory for parity_phase2.json and parity_phase2.md")
    parser.add_argument("--skip-scipy", action="store_true")
    return parser


def main(argv=None) -> int:
    args, dev = parse(build_parser(), argv)
    p = Phase2Parity(load_cfg(args), frames=args.frames, device=dev)
    print(f"comparison table ({args.frames} frames/cell)...")
    comp = p.comparison_table()
    print(f"interpolation table ({args.frames} frames/cell)...")
    interp = p.interpolation_table()
    cross = None
    if not args.skip_scipy:
        print("scipy.griddata cross-check...")
        cross = griddata_cross_check(p.cfg, frames=8, device=dev)

    out = {
        "frames_per_cell": args.frames,
        "comparison": comp,
        "interpolation": interp,
        "griddata_cross_check": cross,
        "reference": REFERENCE_PHASE2,
    }
    rd = Path(args.results_dir)
    rd.mkdir(parents=True, exist_ok=True)
    (rd / "parity_phase2.json").write_text(json.dumps(out, indent=2))
    text = markdown(out)
    (rd / "parity_phase2.md").write_text(text)
    print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
