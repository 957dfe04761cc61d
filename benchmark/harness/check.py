"""The comparison that decides ``correct``.

For each sampled batch, the reference computes the whole batch again from
the same draws (in blocks of frames, after the window has closed and the
port's state is freed) and the port's outputs of the sampled frames, and
its score of the whole batch, are held to it:

* ``pattern_mismatches``: entries of the pilot mask, positions, validity
  and count that differ (an exact comparison, limit 0);
* ``frames_err``: the largest of max|a − a_ref| / rms(a_ref) over the TX
  grid (every TX antenna's copy), the received grid and the channel;
* ``estimate_err``: the larger of the same of the estimate (every TX
  antenna's copy) and the batch's score error |score − score_ref| /
  score_ref. The score's error is held within the estimate's limit and
  has none of its own: its float32 reduction over the batch reads about
  2e-7 in sound runs, and the control's TF32 errors of H and Ĥ average
  out in it to no more, so no limit of its own would part the two.

Each number has its limit in ``limits/<workload>.json``; PERF.md gives the
readings each was set from.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

NUMBERS = ("pattern_mismatches", "frames_err", "estimate_err")


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max|a − ref| / rms(ref), in float64."""
    ref = ref.to(torch.complex128 if ref.is_complex() else torch.float64)
    a = a.to(ref.device, ref.dtype)
    rms = float(ref.abs().pow(2).mean().sqrt())
    return float((a - ref).abs().max()) / max(rms, 1e-300)


def _worst(*values: float) -> float:
    """The largest of ``values``, NaN if any is NaN."""
    return float("nan") if any(v != v for v in values) else max(values)


def readings(kept: Dict, refs: Dict[int, Tuple[Dict, float]]) -> Dict[str, float]:
    """The numbers of ``NUMBERS`` over the sampled batches, and the score's
    own error ``score_err`` (a part of ``estimate_err``): ``kept`` maps a
    batch to the port's ``window.Kept``, ``refs`` to the reference's
    (frames by index, score)."""
    out = dict.fromkeys(NUMBERS + ("score_err",), 0.0)
    out["pattern_mismatches"] = 0
    for i, k in kept.items():
        ref_frames, ref_score = refs[i]
        for j, f in enumerate(k.frames.tolist()):
            r = ref_frames[f]
            mism = 0
            for got, want in ((k.mask[j], r.pattern.mask), (k.positions[j], r.pattern.positions),
                              (k.valid[j], r.pattern.valid), (k.num_pilots[j], r.pattern.num_pilots)):
                mism += int((got.to(want.device).to(torch.float64)
                             != want.to(torch.float64)).sum())
            out["pattern_mismatches"] += mism
            tx_ref = r.tx[:, None, :].expand(k.tx[j].shape)
            out["frames_err"] = _worst(out["frames_err"], rel_err(k.tx[j], tx_ref),
                                       rel_err(k.rx[j], r.rx), rel_err(k.channel[j], r.channel))
            out["estimate_err"] = _worst(out["estimate_err"], rel_err(k.estimate[j], r.estimate))
        score = float(k.score)
        out["score_err"] = _worst(out["score_err"], abs(score - ref_score) / abs(ref_score))
    out["estimate_err"] = _worst(out["estimate_err"], out["score_err"])
    return out


def judge(values: Dict[str, float], limits: Dict[str, float], failed: int) -> Tuple[bool, List[str]]:
    """(correct, one line a number: its value beside its limit)."""
    lines, ok = [], failed == 0
    for name in NUMBERS:
        v, lim = values[name], limits[name]
        good = v == v and v <= lim  # NaN fails
        ok = ok and good
        lines.append(f"check {name} {v!r} limit {lim!r} {'ok' if good else 'FAIL'}")
    lines.append(f"check failed_frames {failed} limit 0 {'ok' if failed == 0 else 'FAIL'}")
    return ok, lines
