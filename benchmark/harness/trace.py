"""A ``torch.profiler`` trace of a stretch of batches, reduced to what the
per-layer metrics read.

Only the card's activity is traced (kernels, memcpys, memsets and the
CUDA runtime calls that launch them): recording every PyTorch operation
on the host as well doubles the host's time a batch in the host-bound
cells and would read as idle card. The benchmark's spans (``bench.draws``,
``bench.simulate``, ``bench.estimate``, ``bench.score``) are marked by
recording a CUDA event as each opens and once after the last, so that
the runtime's trace holds their host boundaries. A device operation is
attributed to the span whose host interval holds its launch, found by
the launch's correlation id; one whose launch the trace lacks takes the
span of the operation before it on its stream. Where the trace holds
other event records than the markers the spans are not known, and every
operation stays unattributed.

The trace is exported as a Chrome trace under ``TMPDIR`` (the format
every PyTorch version writes alike), read back and deleted.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "cudaEventRecord"


class DeviceOp(NamedTuple):
    name: str
    cat: str
    stream: int
    start_us: float
    dur_us: float
    span: Optional[str]


class Trace(NamedTuple):
    batches: int
    window_s: float  # from the first span's start to the last device operation's end
    busy_s: float  # union of the device operations' intervals
    ops: List[DeviceOp]
    unattributed: int  # operations whose launch the trace lacks
    idle_gaps: List[Tuple[str, float]]  # seconds idle by what the host was doing, longest first

    def span_seconds(self, span: str) -> float:
        return sum(op.dur_us for op in self.ops if op.span == span) * 1e-6


class Markers:
    """``span(name)`` for the traced stretch: records the span's name and
    a CUDA event as the span opens (nothing on the CPU)."""

    def __init__(self, device: torch.device):
        self.names: List[str] = []
        self.event = torch.cuda.Event() if device.type == "cuda" else None
        if self.event is not None:
            self.event.record()  # created before the trace

    def __call__(self, name: str):
        self.names.append(name)
        if self.event is not None:
            self.event.record()
        return contextlib.nullcontext()

    def close(self) -> None:
        if self.event is not None:
            self.event.record()


def record(fn: Callable[[Callable], None], device: torch.device) -> Tuple[Dict, List[str]]:
    """Run ``fn(span)`` under the profiler and return the Chrome trace and
    the names of the spans in the order they opened."""
    markers = Markers(device)
    activities = [torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
                  else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=activities) as prof:
        fn(markers)
        markers.close()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh), markers.names
    finally:
        os.remove(path)


def _short(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name.replace("(anonymous namespace)::", "")[:120]


def reduce(chrome: Dict, names: List[str], batches: int) -> Trace:
    """The trace of ``batches`` batches whose spans opened as ``names``."""
    events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    runtime = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                     for e in events if e.get("cat") in LAUNCH_CATS)
    marks = [r[0] for r in runtime if r[2].startswith(MARKER)]
    if not names or len(marks) != len(names) + 1:
        marks = []
    spans = [(a, b, n) for a, b, n in zip(marks, marks[1:], names)]
    starts = [sp[0] for sp in spans]

    def span_at(ts: float) -> Optional[str]:
        i = bisect.bisect_right(starts, ts) - 1
        return spans[i][2] if i >= 0 and ts <= spans[i][1] else None

    launch_ts = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = float(e["ts"])
    raw = sorted((float(e["ts"]), e) for e in events if e.get("cat") in DEVICE_CATS)
    ops: List[DeviceOp] = []
    last_span: Dict[int, Optional[str]] = {}
    unattributed = 0
    for ts, e in raw:
        args = e.get("args", {})
        stream = int(args.get("stream", e.get("tid", 0)) or 0)
        corr = args.get("correlation")
        span = span_at(launch_ts[corr]) if corr in launch_ts else last_span.get(stream)
        unattributed += span is None or corr not in launch_ts
        last_span[stream] = span
        ops.append(DeviceOp(_short(e["name"]), e["cat"], stream, ts, float(e.get("dur", 0)), span))
    if not ops:
        return Trace(batches, 0.0, 0.0, [], 0, [])

    t0 = marks[0] if marks else min(op.start_us for op in ops)
    t1 = max([marks[-1] if marks else t0] + [op.start_us + op.dur_us for op in ops])
    busy: List[List[float]] = []
    for op in sorted(ops, key=lambda o: o.start_us):
        a, b = max(op.start_us, t0), min(op.start_us + op.dur_us, t1)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    busy_us = sum(b - a for a, b in busy)
    return Trace(batches, (t1 - t0) * 1e-6, busy_us * 1e-6, ops, unattributed,
                 _idle_gaps(runtime, busy, t0, t1, span_at))


def _idle_gaps(runtime, busy, t0, t1, span_at) -> List[Tuple[str, float]]:
    """Seconds the card sat idle, by what the host was doing in the middle
    of each gap: '<span>/<CUDA runtime call>', or '<span>/host' (Python
    and PyTorch between calls)."""
    starts = [r[0] for r in runtime]
    gaps, edge = [], t0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if t1 > edge:
        gaps.append((edge, t1))
    total: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        what = runtime[i][2] if i >= 0 and runtime[i][1] >= mid else "host"
        total[f"{span_at(mid) or 'between spans'}/{what}"] += (b - a) * 1e-6
    return sorted(total.items(), key=lambda kv: -kv[1])


def kernel_ops(trace: Trace, names) -> List[DeviceOp]:
    """The device operations of the kernels ``names`` (their function
    names, without template arguments or namespace)."""
    def ident(name: str) -> str:
        return name.split("(")[0].split("<")[0].strip()

    return [op for op in trace.ops if op.cat == "kernel" and ident(op.name) in names]


def top_device_ops(trace: Trace, n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` device operations that took the most time, by name."""
    total: Dict[str, float] = defaultdict(float)
    for op in trace.ops:
        total[op.name] += op.dur_us * 1e-6
    return sorted(total.items(), key=lambda kv: -kv[1])[:n]
