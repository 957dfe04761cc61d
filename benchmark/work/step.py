"""Work of one step of the timed entry: draw → simulate → estimate → score.

Counted from the shapes, the pilots and the estimator's algorithm, never
from which kernel or route ran, so that a later change to the program
cannot move it. ``step_mfu`` divides the least time this work takes by
the measured time a batch.

Bytes: the draws read once; what the entry returns written once (the
frame's arrays, the TX grid and the estimate by their distinct values,
without the broadcast along TX); the score reading H and Ĥ once.

Operations (real operations, 8 a complex multiply-add; cos, sin, exp and
a comparison count one each), with S symbols, K subcarriers, R and T
antennas, O oscillators, P a frame's profile paths, n its pilots:

* pattern: 25 threshold comparisons a uniform;
* TX grid: cos and sin a resource element;
* Jakes: 2 a (path, antenna pair, oscillator) for its Doppler, 6 a
  symbol of it (phase, cos, sin, two sums), 2 a gain for its amplitude;
* channel: 8·P a channel coefficient;
* received grid: 2·(T − 1)·P a (symbol, RX) for the TX sum of the gains,
  then 8·P + 14 a received value (the response, times x, its power, the
  noise);
* LS: 11 a pilot for 1/x, 6 a pilot and RX;
* the interpolation: the frozen ``work()`` count of its form;
* mmse_full, float64: the pilot sums 8·R·n·P and 4·R·S·P·m, the
  pilot-pair sums 8·n·P(P + 1)/2, the Wiener gram 2·S·(P·m)², the
  refinement's residual 8·(P·m)²·R and the time-domain reconstruction
  4·S·R·P·m; float32: one factorization and two substitutions of the
  (P·m)-system (the solve and its refinement), and the delay→subcarrier
  reconstruction 8·S·R·K·P;
* score: 10 a channel coefficient.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from benchmark.reference.carrier import MAX_PATHS, Carrier
from benchmark.work import interp, interp_fused


def work(carrier: Carrier, estimator: str, method: str, rank: Optional[int],
         paths: Sequence[int], n_pilots: Sequence[int],
         mask: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """{'bytes', 'fp32', 'fp64'} of one batch whose frames have ``paths``
    profile paths and ``n_pilots`` pilots each; ``mask`` (B, S, K) is
    needed for the grid-form interpolation."""
    b = len(n_pilots)
    s, k = carrier.num_symbols, carrier.num_subcarriers
    r, t, o = carrier.num_rx, carrier.num_tx, carrier.num_oscillators
    p_max = carrier.max_pilots
    sk, srk, srtk = s * k, s * r * k, s * r * t * k

    nbytes = b * (4 * sk + 4 * sk + 2 * 4 * MAX_PATHS * r * t * o + 2 * 4 * srk)  # draws
    nbytes += b * (8 * sk + 8 * srk + 8 * srtk + 4 * sk + 8 * p_max + 4 * p_max + 4)  # frame
    nbytes += b * 8 * srk  # estimate
    nbytes += b * (8 * srtk + 8 * srk)  # score reads

    fp32 = 0.0
    fp64 = 0.0
    for p, n in zip(paths, n_pilots):
        fp32 += 25 * sk + 2 * sk
        fp32 += 2 * p * r * t * o + 6 * s * p * r * t * o + 2 * s * r * t * p
        fp32 += 8 * p * srtk
        fp32 += 2 * (t - 1) * p * s * r + (8 * p + 14) * srk
        fp32 += 11 * n + 6 * r * n
        fp32 += 10 * srtk
        if estimator == "mmse_full":
            m = rank if rank is not None else s
            ns = p * m
            fp64 += 8 * r * n * p + 4 * r * s * p * m + 8 * n * p * (p + 1) / 2
            fp64 += 2 * s * ns * ns + 8 * ns * ns * r + 4 * s * r * p * m
            fp32 += 8 * (ns ** 3 / 6 + 2 * ns * ns * r) + 8 * s * r * k * p
    if estimator == "ls":
        if method in ("nearest", "linear"):
            if mask is None:
                raise ValueError("the grid-form count needs the pilot masks")
            fp32 += interp_fused.work(mask, r, method)[1]
        else:
            fp32 += interp.work(b, r, p_max, s, k, n_pilots, method)[1]
    elif estimator != "mmse_full":
        raise ValueError(f"no step count for estimator {estimator!r}")
    return {"bytes": float(nbytes), "fp32": fp32, "fp64": fp64}
