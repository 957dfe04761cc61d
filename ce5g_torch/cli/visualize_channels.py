"""Channel visualization CLI.

Port of scripts/visualize_channels.py. Parity surface: reference
visualize_channel_phase1.py:17-228 — per-model channel heatmaps,
Doppler-sweep figures, temporal autocorrelation (with an extended
50-symbol frame). :func:`channel_arrays` computes every array the figures
show; matplotlib only draws them. With ``--no-plots`` the arrays are
written to <results-dir>/channel_arrays.npz instead of figures.

    python -m ce5g_torch.cli.visualize_channels --results-dir DIR [--no-plots]
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..physics import (
    PROFILE_INDEX,
    PROFILE_NAMES,
    FrameDraws,
    FrameParams,
    draw_frames,
    simulate_frame,
)
from ._common import load_cfg, make_parser, parse

#: the reference's extended frame for the autocorrelation (:160-165)
EXTENDED_SYMBOLS = 50
LAGS = 25
HEATMAP_DOPPLER_HZ = 100.0
DENSITY = 0.1


def autocorrelation(h: np.ndarray, lags: int = LAGS) -> np.ndarray:
    """|autocorrelation| over time of a (S, K) channel at lags 0…lags−1,
    normalised by its mean power."""
    s = h.shape[0]
    power = np.mean(np.abs(h) ** 2)
    return np.asarray([np.abs(np.mean(h[: s - lag] * np.conj(h[lag:]))) / power
                       for lag in range(lags)])


def seeded_draws(cfg: ExperimentConfig, device) -> FrameDraws:
    """One frame's draws from a generator seeded ``cfg.seed`` (the JAX
    script keys every frame with ``key(cfg.seed)``)."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    params = FrameParams(*(torch.zeros(1, dtype=dt, device=device)
                           for dt in (torch.int32, torch.float32, torch.float32, torch.float32)))
    return FrameDraws(*(x[0] for x in draw_frames(gen, params, cfg, device=device)))


def channel_arrays(cfg: ExperimentConfig, snr: float, device,
                   draws_for: Optional[Callable[[ExperimentConfig], FrameDraws]] = None
                   ) -> Dict[str, Dict]:
    """Every array of the three figures, on the host: {"heatmaps":
    {profile: |H| (S, K) at 100 Hz}, "doppler": {Hz: |H| (S, K) of EVA},
    "autocorrelation": {Hz: (LAGS,) of EVA over a 50-symbol frame}}, of
    the (rx0, tx0) pair. Every frame of one config has the same draws,
    ``draws_for(config)`` (default :func:`seeded_draws`)."""
    draws_for = draws_for or (lambda c: seeded_draws(c, device))
    ext_cfg = dataclasses.replace(
        cfg, ofdm=dataclasses.replace(cfg.ofdm, num_symbols=EXTENDED_SYMBOLS))
    draws = {cfg: draws_for(cfg), ext_cfg: draws_for(ext_cfg)}

    def h00(profile: str, doppler: float, c: ExperimentConfig) -> np.ndarray:
        params = FrameParams(
            torch.tensor(PROFILE_INDEX[profile], dtype=torch.int32),
            torch.tensor(doppler, dtype=torch.float32),
            torch.tensor(snr, dtype=torch.float32),
            torch.tensor(DENSITY, dtype=torch.float32),
        )
        frame = simulate_frame(draws[c], params, cfg=c, device=device)
        return frame.channel[:, 0, 0, :].cpu().numpy()

    dopplers = [float(fd) for fd in cfg.channel.doppler_hz]
    return {
        "heatmaps": {p: np.abs(h00(p, HEATMAP_DOPPLER_HZ, cfg)) for p in PROFILE_NAMES},
        "doppler": {fd: np.abs(h00("EVA", fd, cfg)) for fd in dopplers},
        "autocorrelation": {fd: autocorrelation(h00("EVA", fd, ext_cfg)) for fd in dopplers},
    }


def _plot(arrays: Dict[str, Dict], out: Path) -> None:
    from ..eval.report import _plt

    plt = _plt()
    # 1. per-model heatmaps (|H| over time-frequency)
    fig, axes = plt.subplots(1, 3, figsize=(16, 4))
    for ax, (name, img) in zip(axes, arrays["heatmaps"].items()):
        im = ax.imshow(img, aspect="auto", cmap="viridis")
        ax.set_title(f"{name} |H| ({HEATMAP_DOPPLER_HZ:.0f} Hz)")
        ax.set_xlabel("subcarrier")
        ax.set_ylabel("symbol")
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(out / "channel_models.png", dpi=120)
    plt.close(fig)

    # 2. Doppler sweep: same profile, increasing time variation
    fig, axes = plt.subplots(1, len(arrays["doppler"]), figsize=(18, 4))
    for ax, (fd, img) in zip(np.atleast_1d(axes), arrays["doppler"].items()):
        ax.imshow(img, aspect="auto", cmap="viridis")
        ax.set_title(f"EVA {fd:.0f} Hz")
        ax.set_xlabel("subcarrier")
    fig.tight_layout()
    fig.savefig(out / "doppler_sweep.png", dpi=120)
    plt.close(fig)

    # 3. temporal autocorrelation over the extended frame
    fig, ax = plt.subplots(figsize=(8, 5))
    for fd, ac in arrays["autocorrelation"].items():
        ax.plot(range(len(ac)), ac, marker=".", label=f"{fd:.0f} Hz")
    ax.set_xlabel("lag (symbols)")
    ax.set_ylabel("|autocorrelation|")
    ax.set_title("Temporal channel correlation (EVA)")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out / "temporal_autocorrelation.png", dpi=120)
    plt.close(fig)


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--results-dir", required=True, help="directory for the figures")
    parser.add_argument("--snr", type=float, default=20.0)
    parser.add_argument("--no-plots", action="store_true",
                        help="write the figures' arrays (channel_arrays.npz), not figures")
    return parser


def main(argv=None) -> int:
    args, dev = parse(build_parser(), argv)
    cfg = load_cfg(args)
    out = Path(args.results_dir)
    out.mkdir(parents=True, exist_ok=True)
    arrays = channel_arrays(cfg, args.snr, dev)
    if args.no_plots:
        flat = {f"{part}/{key}": value for part, d in arrays.items() for key, value in d.items()}
        np.savez(out / "channel_arrays.npz", **flat)
        print(f"arrays → {out}/channel_arrays.npz")
        return 0
    _plot(arrays, out)
    print(f"figures → {out}/channel_models.png, doppler_sweep.png, "
          "temporal_autocorrelation.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
