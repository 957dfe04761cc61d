"""The readings that the limits of ``limits/<workload>.json`` are set from.

    python3 benchmark/control.py --workload <cell> --program-seeds 1 2 ... --control-seeds 7 8 9

For each seed, the batches and frames the check samples (drawn from the
seed, as a run draws them) are computed

* by the port at the cell's own size, untimed: its readings against the
  reference, of which the largest over a dozen seeds is a number's lower
  reading;
* by the control, the reference put in the port's place a precision step
  lower (``reference.precision.CONTROL``): its readings, of which the
  least is a number's upper reading, and which has to fail a limit.

Prints one JSON line a seed and side, and last the lower and upper
readings of each number. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import check, draws, spec, window  # noqa: E402
from benchmark.harness.runner import sample_plan  # noqa: E402
from benchmark.reference import pipeline  # noqa: E402
from benchmark.reference.carrier import Carrier  # noqa: E402
from benchmark.reference.estimators import time_rank  # noqa: E402
from benchmark.reference.precision import CONTROL, REFERENCE  # noqa: E402


def _as_kept(frames: Dict[int, pipeline.FrameOutputs], score: float, idx: torch.Tensor,
             num_tx: int) -> window.Kept:
    """The control's outputs in the form the check reads the port's."""
    rows = [frames[f] for f in idx.tolist()]
    stack = lambda xs: torch.stack(list(xs))  # noqa: E731
    tx = stack(r.tx[:, None, :].expand(r.tx.shape[0], num_tx, r.tx.shape[1]) for r in rows)
    return window.Kept(idx, stack(r.pattern.mask for r in rows),
                       stack(r.pattern.positions for r in rows),
                       stack(r.pattern.valid for r in rows),
                       stack(r.pattern.num_pilots for r in rows), tx,
                       stack(r.rx for r in rows), stack(r.channel for r in rows),
                       stack(r.estimate for r in rows), torch.tensor(score))


def readings(workload: str, seed: int, control: bool, device="cuda", overrides=None) -> Dict:
    """The check's numbers of one seed: of the port, or of the control."""
    cell = spec.Cell(workload)
    config = {**cell.config, **(overrides or {})}
    carrier = Carrier.from_config(config)
    device = torch.device(device)
    inputs = draws.Inputs(seed, config["batch"], carrier, cell.traffic, device)
    plan = sample_plan(seed, config, device)
    rank = time_rank(carrier, config["doppler_hz_configured"])
    est, method = cell.traffic["estimator"], cell.traffic["method"]
    program = None
    if not control:
        from benchmark.harness.program import Program
        program = Program(config, cell.traffic, device)
    kept, refs = {}, {}
    for i, idx in plan.items():
        keep = idx.tolist()
        if control:
            d, params = inputs(i)
            frames, score = pipeline.run_batch(d, params, carrier, est, method, rank, CONTROL,
                                               keep=keep, block=config["reference_block"])
            kept[i] = _as_kept(frames, score, idx, carrier.num_tx)
        else:
            frames, h, score = window.one_batch(program, inputs, i)
            kept[i] = window.keep(frames, h, score, idx)
            del frames, h
        d, params = inputs(i)
        refs[i] = pipeline.run_batch(d, params, carrier, est, method, rank, REFERENCE, keep=keep,
                                     block=config["reference_block"])
        del d
    values = check.readings(kept, refs)
    ok, _ = check.judge(values, cell.limits, 0)
    return {"workload": workload, "seed": seed, "side": "control" if control else "program",
            "correct": ok, **values}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sides: Dict[str, List[Dict]] = {"program": [], "control": []}
    for side, seeds in (("program", args.program_seeds), ("control", args.control_seeds)):
        for seed in seeds:
            r = readings(args.workload, seed, side == "control", args.device)
            sides[side].append(r)
            print(json.dumps(r), flush=True)
    summary = {"workload": args.workload}
    for name in check.NUMBERS + ("score_err",):
        if sides["program"]:
            summary[f"{name}.lower"] = max(r[name] for r in sides["program"])
        if sides["control"]:
            summary[f"{name}.upper"] = min(r[name] for r in sides["control"])
    summary["control_correct"] = [r["correct"] for r in sides["control"]]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
