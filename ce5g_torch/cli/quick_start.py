"""End-to-end demo: simulate → LS → MMSE (diag + full) → figures.

Port of scripts/quick_start.py. Parity surface: reference
quick_start.py:27-230 (EVA, 50 Hz, 15 dB, 10% pilots; NMSE printout;
6-panel heatmap + frequency-response figure). The frame is drawn from a
``torch.Generator`` seeded with the config's seed.

    python -m ce5g_torch.cli.quick_start --results-dir DIR [--no-plots] [--device cpu]
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..estimators import estimate_frame
from ..physics import PROFILE_INDEX, FrameDraws, FrameParams, draw_frames, simulate_frame
from ..utils import evaluate_estimator
from ._common import load_cfg, make_parser, parse, sync

ESTIMATORS = (("ls", "LS"), ("mmse", "MMSE (diag)"), ("mmse_full", "MMSE (Wiener)"))


def simulate(cfg: ExperimentConfig, channel: str, doppler: float, snr: float, density: float,
             device, draws: Optional[FrameDraws] = None):
    """One frame of ``channel`` at ``doppler`` Hz, ``snr`` dB and
    ``density`` pilots. Its draws are the first frame of ``draw_frames``
    from a generator seeded ``cfg.seed`` unless ``draws`` (unbatched)
    are given."""
    params = FrameParams(
        torch.tensor(PROFILE_INDEX[channel], dtype=torch.int32, device=device),
        torch.tensor(doppler, dtype=torch.float32, device=device),
        torch.tensor(snr, dtype=torch.float32, device=device),
        torch.tensor(density, dtype=torch.float32, device=device),
    )
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        batch = FrameParams(*(x[None] for x in params))
        draws = FrameDraws(*(x[0] for x in draw_frames(gen, batch, cfg, device=device)))
    return simulate_frame(draws, params, cfg=cfg, device=device)


def estimates(frame, cfg: ExperimentConfig,
              device) -> Dict[str, Tuple[torch.Tensor, float, float]]:
    """{label: (estimate, NMSE dB, seconds of the call)} for LS, the
    diagonal MMSE and the full Wiener MMSE on ``frame``."""
    out = {}
    for est, label in ESTIMATORS:
        sync(device)
        t0 = time.perf_counter()
        h = estimate_frame(frame, cfg=cfg, estimator=est, device=device)
        sync(device)
        dt = time.perf_counter() - t0
        out[label] = (h, float(evaluate_estimator(frame.channel, h)["nmse_db"]), dt)
    return out


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--channel", default="EVA", choices=["EPA", "EVA", "ETU"])
    parser.add_argument("--doppler", type=float, default=50.0)
    parser.add_argument("--snr", type=float, default=15.0)
    parser.add_argument("--density", type=float, default=0.1)
    parser.add_argument("--results-dir", required=True, help="directory for the figures")
    parser.add_argument("--no-plots", action="store_true")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args, dev = parse(parser, argv)
    cfg = load_cfg(args)
    if args.density > cfg.pilots.max_density:
        parser.error(
            f"--density {args.density} exceeds pilots.max_density "
            f"{cfg.pilots.max_density} (pilot slots beyond it are dropped); "
            "raise max_density in the config"
        )
    print("=" * 60)
    print("5G Channel Estimation on PyTorch — quick start")
    print(f"channel {args.channel}  doppler {args.doppler} Hz  "
          f"SNR {args.snr} dB  pilots {args.density:.0%}  device {dev}")
    print("=" * 60)

    t0 = time.perf_counter()
    frame = simulate(cfg, args.channel, args.doppler, args.snr, args.density, dev)
    sync(dev)
    print(f"simulated frame in {time.perf_counter() - t0:.2f}s incl. first-call setup "
          f"(rx {tuple(frame.rx_symbols.shape)}, H {tuple(frame.channel.shape)})")
    results = estimates(frame, cfg, dev)
    for label, (_, db, dt) in results.items():
        print(f"{label:>14}: NMSE {db:7.2f} dB   ({dt:.2f}s incl. first-call setup)")

    if args.no_plots:
        return 0
    from ..eval.report import _plt

    plt = _plt()
    out = Path(args.results_dir)
    out.mkdir(parents=True, exist_ok=True)
    h_true = frame.channel[:, 0, 0, :].cpu().numpy()
    host_h = {label: h[:, 0, 0, :].cpu().numpy() for label, (h, _, _) in results.items()}
    panels = [("True |H|", np.abs(h_true)), ("Pilot mask", frame.pilot_mask.cpu().numpy())]
    for label, hh in host_h.items():
        panels.append((f"{label} |Ĥ|", np.abs(hh)))
    panels.append(("LS error", np.abs(host_h["LS"] - h_true)))
    fig, axes = plt.subplots(2, 3, figsize=(16, 7))
    for ax, (title, img) in zip(axes.flat, panels):
        im = ax.imshow(img, aspect="auto", cmap="viridis")
        ax.set_title(title)
        ax.set_xlabel("subcarrier")
        ax.set_ylabel("symbol")
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(out / "quick_start_results.png", dpi=120)
    plt.close(fig)

    fig2, ax = plt.subplots(figsize=(10, 4))
    ax.plot(np.abs(h_true[0]), label="|H| true (symbol 0)")
    for label, hh in host_h.items():
        ax.plot(np.abs(hh[0]), alpha=0.7, label=label)
    ax.set_xlabel("subcarrier")
    ax.set_ylabel("magnitude")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig2.tight_layout()
    fig2.savefig(out / "frequency_response.png", dpi=120)
    plt.close(fig2)
    print(f"figures → {out}/quick_start_results.png, {out}/frequency_response.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
