"""The timed window: a closed loop on one stream that runs ahead.

Each batch makes its inputs (``draws``), then runs the port's simulate,
estimate and score; the score is stored on the card and a CUDA event is
recorded after it. Nothing synchronizes inside the window but what the
port does itself. The window closes at the first batch boundary after
``seconds`` of host time (and not before the last batch the check
samples), with one synchronization; its frames are counted over its
whole time, from its start to that synchronization. The events are read
back after it: the time between one batch's completion and the next's.

For the check, the frames drawn from the seed of the batches drawn from
the seed are copied out (``index_select``) as the port returns them.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch


class Kept(NamedTuple):
    """The copied outputs of one sampled batch: its frames ``frames``."""

    frames: torch.Tensor  # (F,) int64 frame indices
    mask: torch.Tensor
    positions: torch.Tensor
    valid: torch.Tensor
    num_pilots: torch.Tensor
    tx: torch.Tensor  # (F, S, T, K)
    rx: torch.Tensor
    channel: torch.Tensor
    estimate: torch.Tensor  # (F, S, R, T, K)
    score: torch.Tensor  # 0-d, the whole batch's


class Record(NamedTuple):
    batches: int
    seconds: float
    batch_ms: List[float]  # one per batch: completion to completion
    scores: torch.Tensor  # (batches,)
    kept: Dict[int, Kept]
    peak_bytes: Optional[int]


def keep(frames, h, score, idx: torch.Tensor) -> Kept:
    take = lambda x: x.index_select(0, idx)  # noqa: E731
    return Kept(idx, take(frames.pilot_mask), take(frames.pilot_positions),
                take(frames.pilot_valid), take(frames.num_pilots), take(frames.tx_symbols),
                take(frames.rx_symbols), take(frames.channel), take(h), score)


def one_batch(program, inputs, index: int, span: Callable = contextlib.nullcontext):
    """(frames, estimate, score) of batch ``index``, each stage in its span
    (``span(name)`` returns a context manager)."""
    with span("bench.draws"):
        draws, params = inputs(index)
        fparams = program.frame_params(params)
    with span("bench.simulate"):
        frames = program.simulate(draws, fparams)
    with span("bench.estimate"):
        h = program.estimate(frames)
    with span("bench.score"):
        score = program.score(frames, h)
    return frames, h, score


class Clock:
    """Batch completion times: CUDA events on the card (created before
    the window), the host clock after each batch on the CPU, whose work
    is synchronous."""

    def __init__(self, device: torch.device, capacity: int):
        self.cuda = device.type == "cuda"
        self.capacity = capacity
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(capacity + 1)]
        self.host: List[float] = []

    def mark(self, i: int) -> None:
        if self.cuda:
            self.events[i].record()
        else:
            self.host.append(time.perf_counter())

    def intervals_ms(self, n: int) -> List[float]:
        if self.cuda:
            ev = self.events
            return [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]
        return [(b - a) * 1e3 for a, b in zip(self.host, self.host[1:n + 1])]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(program, inputs, seconds: float, plan: Dict[int, torch.Tensor], clock: Clock,
        device: torch.device) -> Record:
    """The timed window; ``plan`` maps each sampled batch to its sampled
    frames."""
    scores = torch.empty(clock.capacity, device=device)
    last = max(plan, default=0)
    kept: Dict[int, Kept] = {}
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    clock.mark(0)
    i = 0
    while True:
        frames, h, score = one_batch(program, inputs, i)
        scores[i].copy_(score)
        if i in plan:
            kept[i] = keep(frames, h, score, plan[i])
        del frames, h
        i += 1
        clock.mark(i)
        if i >= clock.capacity or (i > last and time.perf_counter() - t0 >= seconds):
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return Record(i, elapsed, clock.intervals_ms(i), scores[:i], kept, peak)
