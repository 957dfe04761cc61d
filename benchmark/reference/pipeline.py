"""One batch of the timed entry, computed by the reference: the frames,
the estimate and the score, in blocks of frames so that it fits beside
nothing else on the card.

The draws are the benchmark's (``harness.draws``): pilot uniforms, TX
phases, Jakes angles and phases, and the noise. The per-frame parameters
name each frame's profile by its index into ``BatchParams.profiles``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import estimators, frames
from .carrier import Carrier, profile_tables
from .frames import Pattern
from .precision import Precision


class BatchParams(NamedTuple):
    profile: torch.Tensor  # (B,) int64 index into ``profiles``
    doppler_hz: torch.Tensor  # (B,) float32
    snr_db: torch.Tensor  # (B,) float32
    density: torch.Tensor  # (B,) float32
    profiles: Tuple[str, ...]


class FrameOutputs(NamedTuple):
    """What the timed entry returns for one frame."""

    pattern: Pattern  # each field without its batch axis
    tx: torch.Tensor  # (S, K) the grid common to every TX antenna
    rx: torch.Tensor  # (S, R, K)
    channel: torch.Tensor  # (S, R, T, K)
    estimate: torch.Tensor  # (S, R, T, K)


def run_batch(draws: Sequence[torch.Tensor], params: BatchParams, carrier: Carrier,
              estimator: str, method: str, rank: Optional[int], prec: Precision,
              keep: Sequence[int] = (), block: int = 8) -> Tuple[Dict[int, FrameOutputs], float]:
    """The frames ``keep`` of the batch (by index) and the batch's score,
    mean|H − Ĥ|² / (mean|H|² + 1e-12) over every frame, RX, TX,
    symbol and subcarrier."""
    pilot_u, tx_phase, angles, phases, noise_re, noise_im = draws
    b = pilot_u.shape[0]
    amp_t, f_t = profile_tables(params.profiles, carrier, pilot_u.device, prec.real, prec.complex)
    kept: Dict[int, FrameOutputs] = {}
    err = torch.zeros((), dtype=prec.real, device=pilot_u.device)
    pwr = torch.zeros((), dtype=prec.real, device=pilot_u.device)
    for f0 in range(0, b, block):
        sl = slice(f0, min(b, f0 + block))
        pidx = params.profile[sl].to(pilot_u.device)
        amp, f = amp_t[pidx], f_t[pidx]
        pattern = frames.pilot_pattern(pilot_u[sl], carrier, params.density[sl])
        x = frames.tx_grid(tx_phase[sl], prec)
        g = frames.path_gains(angles[sl], phases[sl], params.doppler_hz[sl], amp, carrier, prec)
        h = frames.channel(g, f, prec)
        y = frames.received(h, x, params.snr_db[sl], noise_re[sl], noise_im[sl], prec)
        if estimator == "ls":
            est = estimators.ls_estimate(y, x, pattern, method, method in ("nearest", "linear"),
                                         prec)
        elif estimator == "mmse_full":
            est = estimators.mmse_full(y, x, pattern, amp, f, params.doppler_hz[sl],
                                       params.snr_db[sl], carrier, rank, prec)
        else:
            raise ValueError(f"the reference has no estimator {estimator!r}")
        est = est[:, :, :, None, :].expand(h.shape)
        err = err + ((h - est).abs() ** 2).sum()
        pwr = pwr + (h.abs() ** 2).sum()
        for i in keep:
            if sl.start <= i < sl.stop:
                j = i - sl.start
                kept[i] = FrameOutputs(Pattern(*(p[j] for p in pattern)), x[j], y[j], h[j],
                                       est[j].clone())
        del g, h, y, est
    n = b * carrier.num_symbols * carrier.num_rx * carrier.num_tx * carrier.num_subcarriers
    score = float((err / n) / (pwr / n + 1e-12))
    return kept, score
