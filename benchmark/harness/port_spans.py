"""The port's own spans and counters over a second traced stretch, reduced
to what the per-layer metrics of host dispatch read.

This is the second file of the benchmark that imports the port (the
first, ``program.py``, holds the timed entry), and it imports only
``ce5g_torch.utils.profiling``: the port's span (``annotate``), its switch
(``recording``) and its counter registry (``counters``). A port without
them (a commit before they existed) gives no reading, and every metric
that reads this module reports nothing.

:func:`of` (memoised on the metric readers' ``Context``, on the card
only) builds the port for the cell again, runs one untimed batch, then
runs the traced batches again (``ctx.traced``, the same inputs) under
``trace.record`` with the port's spans recording and
``profiling.annotate`` as the benchmark's span, so that ``bench.draws``
... ``bench.score`` are each batch's roots. A span's ``time.time_ns()``
and the trace's ``ts`` µs + ``baseTimeNanoseconds`` are one clock.
:func:`attribute` gives each device operation to the innermost span whose
interval holds its launch (found by correlation id), each synchronizing
runtime call to the span that holds it, and each idle gap of the card to
the span that holds its midpoint. The port's spans record no CUDA event,
so ``trace.reduce`` would read this stretch as well as the cell's own.

The stretch runs after the cell's own traced stretch and its check, with
recording on: nothing it does reaches the cell's other metrics. It logs
one table of the port's spans to standard error.
"""
from __future__ import annotations

import bisect
import re
import sys
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence

from ce5g_torch.utils import profiling

from . import trace, window
from .program import Program

#: runtime calls in which the host waits for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
#: the port's entry points under the benchmark's spans: host dispatch is read inside them
ENTRIES = ("physics.simulate", "estimators.estimate", "metrics.nmse")
#: the port's counters of host work that a steady batch should not repeat
REBUILDS = ("time_rank.computed", "tables.built", "kernels.loaded")
ROOT_PREFIX = "bench."


def is_sync(name: str) -> bool:
    """A synchronizing runtime call: the three synchronizations, or a
    ``cudaMemcpy`` without ``Async`` (a version suffix ``_v…`` ignored)."""
    name = re.sub(r"_v\d+$", "", name)
    return name in SYNC_CALLS or (name.startswith("cudaMemcpy") and "Async" not in name)


class Row(NamedTuple):
    """One span name's totals over the stretch (self: its children's left out)."""

    name: str
    calls: int
    host_self_ms: float
    device_ms: float
    launches: int
    syncs: int
    idle_ms: float


class Reading(NamedTuple):
    batches: int
    rows: List[Row]  # by the order the names first opened
    ops: int  # device operations in the stretch
    outside: int  # ... whose launch lies outside every span
    missing: int  # ... whose launch the trace lacks
    window_ms: float  # first span's start to the last device operation's end, a batch
    host_us_per_launch: Optional[float]
    syncs_per_batch: float
    dispatch_idle_ms: float
    host_rebuilds_per_batch: float
    device_ms_under: Dict[str, float]  # device ms a batch of the operations inside each name
    sync_calls: Dict[str, Dict[str, int]]  # synchronizing calls by the span name holding them

    def table(self) -> List[str]:
        b = self.batches
        lines = [f"{'port span, a batch':<24} {'calls':>6} {'host ms':>8} {'device ms':>10} "
                 f"{'launches':>9} {'syncs':>6} {'idle ms':>8}"]
        lines += [f"{r.name:<24} {r.calls / b:>6.2f} {r.host_self_ms / b:>8.4f} "
                  f"{r.device_ms / b:>10.4f} {r.launches / b:>9.2f} {r.syncs / b:>6.2f} "
                  f"{r.idle_ms / b:>8.4f}" for r in self.rows]
        return lines


def _chain(i: int, parent: Sequence[int]):
    """Span ``i`` and its ancestors."""
    while i >= 0:
        yield i
        i = parent[i]


def attribute(chrome: Dict, spans: Sequence, batches: int,
              counts: Dict[str, int]) -> Optional[Reading]:
    """The reading of a Chrome trace ``chrome`` of ``batches`` batches whose
    spans (each with ``name``, ``parent``, ``start_ns``, ``end_ns``, in the
    order they opened) were recorded beside it, and ``counts``, the port's
    counters moved over the stretch. None without spans or without the
    trace's ``baseTimeNanoseconds``."""
    base = chrome.get("baseTimeNanoseconds")
    if not spans or base is None or batches <= 0:
        return None
    names = [sp.name for sp in spans]
    parent = [sp.parent for sp in spans]
    start = [(sp.start_ns - base) * 1e-3 for sp in spans]  # µs, the trace's ts
    end = [(sp.end_ns - base) * 1e-3 for sp in spans]

    def innermost(ts: float) -> int:
        """The innermost span holding ``ts``, or −1. Spans nest, so it is the
        last one opened before ``ts`` or one of its ancestors."""
        i = bisect.bisect_right(start, ts) - 1
        while i >= 0 and end[i] < ts:
            i = parent[i]
        return i

    in_port = [not n.startswith(ROOT_PREFIX) for n in names]
    entry = []  # the outermost entry point holding each span, or −1
    for i, n in enumerate(names):
        up = entry[parent[i]] if parent[i] >= 0 else -1
        entry.append(up if up >= 0 else (i if n in ENTRIES else -1))

    events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    runtime = [e for e in events if e.get("cat") in trace.LAUNCH_CATS]
    launch_span = {e["args"]["correlation"]: innermost(float(e["ts"]))
                   for e in runtime if "correlation" in e.get("args", {})}
    syncs = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                   for e in runtime if is_sync(e["name"]))
    sync_starts = [a for a, _, _ in syncs]

    n = len(spans)
    device_us, launches, sync_count, idle_us = [0.0] * n, [0] * n, [0] * n, [0.0] * n
    sync_us = [0.0] * n
    ops = [e for e in events if e.get("cat") in trace.DEVICE_CATS]
    under: Dict[str, float] = defaultdict(float)  # device µs of the operations inside each name
    outside = missing = entry_ops = 0
    for e in ops:
        corr = e.get("args", {}).get("correlation")
        if corr not in launch_span:
            missing += 1
            continue
        i, dur = launch_span[corr], float(e.get("dur", 0))
        if i < 0:
            outside += 1
            continue
        device_us[i] += dur
        launches[i] += 1
        entry_ops += entry[i] >= 0
        for name in {names[j] for j in _chain(i, parent)}:
            under[name] += dur
    sync_calls: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for a, b, call in syncs:
        i = innermost(a)
        if i >= 0:
            sync_count[i] += 1
            sync_us[i] += b - a
            sync_calls[names[i]][call] += 1

    def in_sync(ts: float) -> bool:
        j = bisect.bisect_right(sync_starts, ts) - 1
        return j >= 0 and syncs[j][1] >= ts

    busy: List[List[float]] = []
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in ops):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    t0 = min(start)
    t1 = max([max(end)] + [b for _, b in busy])
    edge, dispatch_idle_us = t0, 0.0
    for a, b in busy + [[t1, t1]]:
        if a > edge:
            mid = 0.5 * (edge + a)
            i = innermost(mid)
            if i >= 0:
                idle_us[i] += a - edge
                if in_port[i] and not in_sync(mid):
                    dispatch_idle_us += a - edge
        edge = max(edge, b)

    child_us = [0.0] * n
    for i in range(n):
        if parent[i] >= 0:
            child_us[parent[i]] += end[i] - start[i]
    rows: Dict[str, List[float]] = {}
    for i, name in enumerate(names):
        r = rows.setdefault(name, [0, 0.0, 0.0, 0, 0, 0.0])
        for k, v in enumerate((1, end[i] - start[i] - child_us[i], device_us[i], launches[i],
                               sync_count[i], idle_us[i])):
            r[k] += v

    entry_us = sum(end[i] - start[i] for i in range(n) if entry[i] == i)
    entry_us -= sum(us for us, top in zip(sync_us, entry) if top >= 0)
    return Reading(
        batches,
        [Row(name, int(r[0]), r[1] * 1e-3, r[2] * 1e-3, int(r[3]), int(r[4]), r[5] * 1e-3)
         for name, r in rows.items()],
        len(ops), outside, missing, (t1 - t0) * 1e-3 / batches,
        entry_us / entry_ops if entry_ops else None,
        sum(c for c, p in zip(sync_count, in_port) if p) / batches,
        dispatch_idle_us * 1e-3 / batches,
        sum(counts.get(k, 0) for k in REBUILDS) / batches,
        {name: us * 1e-3 / batches for name, us in under.items()},
        {name: dict(calls) for name, calls in sync_calls.items()},
    )


def _log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def measure(ctx) -> Optional[Reading]:
    """Run the second traced stretch for ``ctx`` and read it (see the
    module note); None off the card or without the port's spans."""
    if not all(hasattr(profiling, a) for a in ("recording", "annotate", "counters")):
        return None  # a port from before its spans
    if ctx.trace is None or not ctx.traced or ctx.device.type != "cuda":
        return None
    program = Program(ctx.config, ctx.traffic, ctx.device)
    _, _, score = window.one_batch(program, ctx._inputs, -1)
    del score
    window.sync(ctx.device)

    def stretch(_markers):
        for i in ctx.traced:
            _, _, score = window.one_batch(program, ctx._inputs, i, profiling.annotate)
            del score

    with profiling.recording() as spans:
        before = profiling.counters.copy()
        chrome, _ = trace.record(stretch, ctx.device)
        counts = dict(profiling.counters - before)
    del program
    reading = attribute(chrome, spans, len(ctx.traced), counts)
    if reading is None:
        _log("port spans: the trace has no baseTimeNanoseconds or no span was recorded")
        return None
    b = reading.batches
    _log(f"port spans over {b} batches again: {reading.ops} device operations, "
         f"{reading.outside} launched outside every port span or bench.* root, "
         f"{reading.missing} whose launch the trace lacks; host "
         f"{sum(r.host_self_ms for r in reading.rows) / b:.3f} ms a batch in the spans; window "
         f"{reading.window_ms:.3f} ms a batch (the cell's traced stretch "
         f"{ctx.trace.window_s * 1e3 / ctx.trace.batches:.3f}, "
         f"its untimed window {ctx.window.seconds * 1e3 / ctx.window.batches:.3f}); counters "
         + (", ".join(f"{k} {v}" for k, v in sorted(counts.items())) or "none"))
    for line in reading.table():
        _log(line)
    for name, calls in reading.sync_calls.items():
        _log(f"syncs in {name}: " + ", ".join(f"{c} {k / b:g} a batch" for c, k in calls.items()))
    return reading


_NOT_READ = object()


def of(ctx) -> Optional[Reading]:
    """:func:`measure` of ``ctx``, run once however many metrics read it."""
    got = getattr(ctx, "_port_spans", _NOT_READ)
    if got is _NOT_READ:
        got = measure(ctx)
        ctx._port_spans = got
    return got
