"""One run of one cell: set-up, the timed window, on request a traced
stretch, the check, and the metrics.

Set-up builds the port for the cell, makes the clock's events, and runs
two batches of the cell's own shapes (the kernels built or loaded, the
allocator and the libraries warmed, the check's copies made once). The
window follows (``window.run``). With ``trace`` a stretch of the
configuration's ``trace_batches`` batches follows the window under the
profiler (``trace``). Then the peak memory is read, the port's state
freed, and the sampled batches held to the reference (``check``). The
metrics are read by their files under ``metrics/``, given a
:class:`Context`.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference.carrier import Carrier, path_taps_amps
from benchmark.reference.estimators import time_rank
from benchmark.reference.frames import pilot_pattern
from benchmark.reference.precision import REFERENCE
from benchmark.work.peaks import peaks_for

from . import check, draws, spec, trace as trace_mod, window
from .program import Program

WARMUP_BATCHES = 2


class Context:
    """What a metric's reader reads."""

    def __init__(self, cell: spec.Cell, config: Dict, carrier: Carrier, rank, device,
                 inputs: draws.Inputs, record: window.Record, setup_s: float,
                 trace: Optional[trace_mod.Trace], traced: List[int]):
        self.cell = cell
        self.config = config
        self.traffic = cell.traffic
        self.carrier = carrier
        self.batch = config["batch"]
        self.rank = rank
        self.device = device
        self.device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else None
        self.peaks = peaks_for(self.device_name)
        self.window = record
        self.setup_s = setup_s
        self.trace = trace
        self.traced = traced
        self._inputs = inputs
        self._traced_inputs = None

    def traced_inputs(self):
        """(params, pattern) of each traced batch, made again from the seed
        (the pattern by the reference)."""
        if self._traced_inputs is None:
            self._traced_inputs = []
            for i in self.traced:
                d, params = self._inputs(i)
                self._traced_inputs.append((params, pilot_pattern(d[0], self.carrier,
                                                                  params.density)))
        return self._traced_inputs

    def frame_paths(self, params) -> List[int]:
        """The profile paths of each frame of a batch."""
        counts = [int((path_taps_amps(p, self.carrier)[1] > 0).sum()) for p in params.profiles]
        return [counts[i] for i in params.profile.tolist()]


def sample_plan(seed: int, config: Dict, device) -> Dict[int, torch.Tensor]:
    """The batches the check samples and, for each, its frames: drawn
    from the seed."""
    rng = np.random.default_rng(seed)
    batches = rng.choice(config["check_range"], size=config["check_batches"], replace=False)
    return {int(i): torch.as_tensor(np.sort(rng.choice(config["batch"], config["check_frames"],
                                                       replace=False)), device=device)
            for i in sorted(batches)}


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        overrides: Optional[Dict] = None, t_start: Optional[float] = None,
        repo=spec.REPO, root=None, log: Callable = lambda *a: None) -> Dict:
    """One run; returns the result line's fields, with 'checks' (the
    numbers compared beside their limits) and 'check_lines'."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = spec.Cell(workload, repo, root)
    config = {**cell.config, **(overrides or {})}
    carrier = Carrier.from_config(config)
    b = config["batch"]
    program = Program(config, cell.traffic, device)
    inputs = draws.Inputs(seed, b, carrier, cell.traffic, device)
    plan = sample_plan(seed, config, device)
    clock = window.Clock(device, config["max_batches"])

    for j in range(WARMUP_BATCHES):  # indices no window batch takes
        frames, h, score = window.one_batch(program, inputs, -1 - j)
        window.keep(frames, h, score, next(iter(plan.values())))
        del frames, h, score
    if device.type == "cuda":
        clock.events[0].record()
        clock.events[0].synchronize()
    window.sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s")

    record = window.run(program, inputs, seconds, plan, clock, device)
    log(f"window: {record.batches} batches of {b} in {record.seconds:.3f} s")
    quarter = max(1, record.batches // 4)
    log("ms a batch by quarter of the window: " + " ".join(
        f"{sum(record.batch_ms[q:q + quarter]) / len(record.batch_ms[q:q + quarter]):.3f}"
        for q in range(0, quarter * 4, quarter) if record.batch_ms[q:q + quarter]))

    traced: List[int] = []
    tr = None
    if trace:
        traced = list(range(record.batches, record.batches + config["trace_batches"]))

        def stretch(span):
            for i in traced:
                _, _, score = window.one_batch(program, inputs, i, span)
                del score

        window.sync(device)
        tr = trace_mod.reduce(*trace_mod.record(stretch, device), len(traced))
        log(f"traced {len(traced)} batches: window {tr.window_s:.4f} s, busy {tr.busy_s:.4f} s, "
            f"{len(tr.ops)} device operations ({tr.unattributed} by stream order)")

    peak = (max(setup_peak, torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else None)
    scores = record.scores.double().cpu()
    failed_batches = int((~torch.isfinite(scores)).sum())
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rank = time_rank(carrier, config["doppler_hz_configured"])
    refs = {}
    t_ref = time.perf_counter()
    for i, k in record.kept.items():
        d, params = inputs(i)
        refs[i] = ref_pipeline.run_batch(d, params, carrier, cell.traffic["estimator"],
                                         cell.traffic["method"], rank, REFERENCE,
                                         keep=k.frames.tolist(), block=config["reference_block"])
        del d
    log(f"reference over {len(refs)} batches: {time.perf_counter() - t_ref:.2f} s")
    values = check.readings(record.kept, refs)
    correct, lines = check.judge(values, cell.limits, failed_batches * b)

    ctx = Context(cell, config, carrier, rank, device, inputs, record, setup_s, tr, traced)
    metrics = {}
    for m in cell.metrics(per_layer=trace):
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": ctx.device_name or device.type, "count": 1,
           "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": record.batches * b, "failed": failed_batches * b,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in trace_mod.top_device_ops(tr)],
                            "idle_gaps": [list(x) for x in tr.idle_gaps[:10]]}
    out["checks"] = {n: {"value": values[n], "limit": cell.limits[n]} for n in check.NUMBERS}
    out["checks"]["failed_frames"] = {"value": failed_batches * b, "limit": 0}
    out["check_lines"] = lines
    return out
