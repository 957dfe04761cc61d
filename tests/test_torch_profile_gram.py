"""The Wiener MMSE's pilot sums in one call (``ce5g_torch.ops.profile_gram``).

On the CPU: the plain version's E and D equal the per-frame einsums of
``mmse_full_estimate``'s route without the profile tables on a batch that
mixes EPA, EVA and ETU (their padded paths included), 1–10% pilots and
−5 to 30 dB, and ``mmse_full`` gives the same estimate by either route; the
wrapper runs the plain version in ``ops.profile_gram.plain`` and raises on
inputs it does not take; and the kernel's layout, walked in Python as the
kernel walks it (the plan's blocks, each round's 16-byte copies at either
alignment, the pilots' threads and the pairs of D), takes every element and
sum once. The tests marked ``cuda`` hold the kernel to the plain version
on a card, a frame alone and in its batch, and its refusals.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from ce5g_torch import ExperimentConfig, MIMOConfig, OFDMConfig
from ce5g_torch.estimators.ls import masked_ls_grid
from ce5g_torch.estimators.mmse import mmse_full_estimate
from ce5g_torch.ops import profile_gram as pg
from ce5g_torch.physics import FrameParams, draw_frames, simulate_batch
from ce5g_torch.physics.profiles import MAX_PATHS, PROFILE_INDEX
from ce5g_torch.physics.simulate import table_for, table_tensors
from ce5g_torch.utils import profiling

CPU = torch.device("cpu")
#: (profile, Doppler Hz, SNR dB, pilot density): one frame each
CASES = (
    ("EPA", 10.0, 30.0, 0.01),
    ("EPA", 200.0, -5.0, 0.10),
    ("EVA", 10.0, -5.0, 0.01),
    ("EVA", 200.0, 30.0, 0.10),
    ("ETU", 200.0, 30.0, 0.02),
    ("ETU", 10.0, 5.0, 0.05),
)


def _cfg(r=2, t=2, s=14, k=120):
    return ExperimentConfig(
        ofdm=OFDMConfig(fft_size=256, cp_length=16, num_symbols=s, useful_subcarriers=k),
        mimo=MIMOConfig(num_tx=t, num_rx=r),
    )


def _frames(cfg, seed=0, device=CPU):
    params = FrameParams(
        torch.tensor([PROFILE_INDEX[c[0]] for c in CASES], dtype=torch.int32, device=device),
        torch.tensor([c[1] for c in CASES], device=device),
        torch.tensor([c[2] for c in CASES], device=device),
        torch.tensor([c[3] for c in CASES], device=device))
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = draw_frames(gen, params, cfg, device=device)
    return simulate_batch(draws, params, cfg=cfg, device=device)


def _args(cfg, frames):
    table = table_for(cfg)
    tables = pg.build_f_tables(table.freq_response, frames.rx_symbols.device)
    return (frames.rx_symbols, frames.tx_symbols[:, :, 0, :], frames.pilot_mask, tables,
            frames.params.profile_idx.long())


def _rms(x):
    return float(x.abs().pow(2).mean().sqrt())


def test_plain_matches_the_einsum_route():
    """E and D against each frame's own (C, P, K) table, as the route
    without the tables contracts them: E to float64 rounding (both add exact
    products of float32 values); D within the float32 rounding of the packed
    D table's products (2⁻²⁴ of each term)."""
    cfg = _cfg()
    frames = _frames(cfg)
    rx, tx, mask, tables, pidx = _args(cfg, frames)
    e, d = pg.profile_gram(rx, tx, mask, tables, pidx)
    _, f_table = table_tensors(table_for(cfg), cfg, CPU)
    f = f_table[pidx].to(torch.complex128)
    m = mask.to(torch.float64)
    g = masked_ls_grid(rx, tx, m).to(torch.complex128)
    want_e = torch.einsum("brsk,bpk->brsp", g, f.conj())
    want_d = torch.einsum("bsk,bpqk->bspq", m.to(g.dtype), f.conj()[:, :, None] * f[:, None])
    assert e.dtype == d.dtype == torch.complex128
    assert e.shape == (len(CASES), 2, 14, MAX_PATHS) and d.shape == (len(CASES), 14, 9, 9)
    assert float((e - want_e).abs().max()) <= 1e-12 * _rms(want_e)
    assert float((d - want_d).abs().max()) <= 1e-6 * _rms(want_d)
    # every frame has paths padded past its live taps on this grid (their
    # weight is zero: the sums take every path of the table)
    live = table_tensors(table_for(cfg), cfg, CPU)[0][pidx] > 0
    assert live.sum(1).tolist() == [3, 3, 6, 6, 6, 6]
    assert torch.equal(d, d.mH)


def test_mmse_full_agrees_by_either_route():
    """``mmse_full`` with the profile tables (``ops.profile_gram``) and
    without them (the einsums): each frame within 1e-6 of its rms."""
    cfg = _cfg()
    frames = _frames(cfg, seed=1)
    rx, tx, mask, tables, pidx = _args(cfg, frames)
    amp_t, f_t = table_tensors(table_for(cfg), cfg, CPU)
    common = (rx, tx, mask, cfg.mimo.num_tx, frames.params.snr_db, f_t[pidx], amp_t[pidx],
              frames.params.doppler_hz, cfg.ofdm.symbol_duration)
    by_table = mmse_full_estimate(*common, time_rank=5, f_tables=tables, profile_idx=pidx)
    by_einsum = mmse_full_estimate(*common, time_rank=5)
    for a, b in zip(by_table, by_einsum):
        assert float((a - b).abs().max()) <= 1e-6 * _rms(b)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    cfg = _cfg()
    args = _args(cfg, _frames(cfg))
    before = profiling.counters.copy()
    with profiling.recording() as spans:
        pg.profile_gram(*args)
    assert dict(profiling.counters - before) == {"ops.profile_gram.plain": 1,
                                                 "mmse_full.profile_tables": 3}
    assert profiling.launches("profile_gram", profiling.counters - before) == 0
    assert [(sp.name, sp.parent) for sp in spans] == [
        ("ops.profile_gram", -1), ("ops.profile_gram.plain", 0)]


def test_wrapper_raises_on_what_it_does_not_take():
    cfg = _cfg()
    rx, tx, mask, tables, pidx = _args(cfg, _frames(cfg))
    with pytest.raises(ValueError, match="rx must be"):
        pg.profile_gram(rx[0], tx, mask, tables, pidx)
    with pytest.raises(ValueError, match="tx"):
        pg.profile_gram(rx, tx[:, :, :-1], mask, tables, pidx)
    with pytest.raises(ValueError, match="mask"):
        pg.profile_gram(rx, tx, mask[:1], tables, pidx)
    with pytest.raises(ValueError, match="pidx"):
        pg.profile_gram(rx, tx, mask, tables, pidx[:1])
    with pytest.raises(TypeError, match="integer"):
        pg.profile_gram(rx, tx, mask, tables, pidx.float())
    other = pg.build_f_tables(table_for(_cfg(k=60)).freq_response, CPU)
    with pytest.raises(ValueError, match="tables"):
        pg.profile_gram(rx, tx, mask, other, pidx)
    with pytest.raises(ValueError, match="different devices"):
        pg.profile_gram(rx, tx, mask, tables, pidx.to("meta"))


#: (B, S, R, K) of the benchmark's cells: bench_4x4, nr100_4x64,
#: lte_frame_etu300_4x4, factory_2x2, nr_frame_hst500_4x4
BENCH_SHAPES = ((256, 14, 4, 599), (64, 14, 64, 3275), (512, 140, 4, 599), (2048, 14, 2, 599),
                (128, 280, 4, 611))


@pytest.mark.parametrize("shape", BENCH_SHAPES)
def test_plan_fits_the_kernel(shape):
    b, s, r, k = shape
    pl = pg.plan_for(b, s, r, k, MAX_PATHS)
    want = {  # route, groups, rows, round_rows, strides, chunk
        (256, 14, 4, 599): ("split", 2, 2, 2, 7, 96),
        (64, 14, 64, 3275): ("split", 5, 13, 1, 28, 416),
        (512, 140, 4, 599): ("whole", 1, 4, 4, 7, 96),
        (2048, 14, 2, 599): ("whole", 1, 2, 2, 7, 96),
        (128, 280, 4, 611): ("whole", 1, 4, 4, 7, 96),
    }[shape]
    assert (pl.route, pl.groups, pl.rows, pl.round_rows, pl.strides, pl.chunk) == want
    assert pl.round_rows * MAX_PATHS * pl.strides <= pg.THREADS
    assert pl.groups * pl.rows >= r > (pl.groups - 1) * pl.rows
    assert pl.tasks == b * s * pl.groups >= pg.MIN_TASKS
    assert pl.round_rows * k * 8 <= max(pg.STAGE_BYTES, k * 8)
    assert pl.shared == pg.shared_bytes(k, MAX_PATHS, pl.round_rows, pl.chunk)
    # two blocks a multiprocessor at nr100_4x64 and four at the others (228
    # KB, 1 KB reserved a block, 32 B of static counts)
    assert (pl.shared + 1024 + 32) * (2 if k == 3275 else 4) <= 228 * 1024


def test_plan_refuses_what_the_kernel_does_not_hold():
    with pytest.raises(ValueError, match="paths"):
        pg.plan_for(2, 14, 4, 599, MAX_PATHS + 1)
    with pytest.raises(ValueError, match="subcarriers"):
        pg.plan_for(2, 14, 4, pg.MAX_K + 1, 9)
    with pytest.raises(ValueError, match="no profile_gram plan"):
        pg.plan_for(2, 0, 4, 599, 9)


def test_the_source_holds_the_wrappers_constants():
    src = (Path(pg.__file__).resolve().parent.parent / "csrc" / "profile_gram.cu").read_text()
    assert pg.MAX_KERNEL_PATHS == MAX_PATHS
    for line in (f"constexpr int kThreads = {pg.THREADS};",
                 f"constexpr int kMaxPaths = {MAX_PATHS};",
                 f"constexpr int kMaxK = {pg.MAX_K};",
                 f"constexpr size_t kMaxShared = {pg.MAX_SHARED};"):
        assert line in src


def _copies(start, n):
    """The elements of a run of ``n`` that starts at element ``start`` of
    the grid, as ``copy_run`` copies them (the grid's base on a 16-byte
    boundary): {element: (buffer index, bytes)}, asserting each 16-byte copy
    aligned at both ends."""
    head = start & 1
    got = {}
    if head and n > 0:
        got[0] = (head, 8)
    pairs = (n - head) // 2
    for v in range(pairs):
        e = head + 2 * v
        assert (start + e) % 2 == 0 and (head + e) % 2 == 0  # 16-byte words
        for x in (e, e + 1):
            assert x not in got
            got[x] = (head + x, 16)
    tail = head + 2 * pairs
    if tail < n:
        assert tail not in got
        got[tail] = (head + tail, 8)
    return got


@pytest.mark.parametrize("shape", [(3, 6, 3, 39), (2, 14, 64, 599), (1, 140, 4, 599),
                                   (2, 5, 7, 65), (1, 3, 64, 3275)])
def test_blocks_copy_every_element_once(shape):
    """Task i takes antennas [g·rows, ...) of row (b, s) = divmod(i //
    groups, S), g = i % groups: every (b, s, r) once, and each round's run
    copied whole into its buffer, at either alignment, within the buffer's
    stride."""
    b, s, r, k = shape
    pl = pg.plan_for(b, s, r, k, MAX_PATHS)
    stride = (pl.round_rows * k + 2) & ~1
    seen = np.zeros((b, s, r), np.int64)
    for i in range(pl.tasks):
        grp, bs = i % pl.groups, i // pl.groups
        r0, count = grp * pl.rows, min(pl.rows, r - grp * pl.rows)
        assert count >= 1
        seen[bs // s, bs % s, r0:r0 + count] += 1
        for rd in range(-(-count // pl.round_rows)):
            n = min(pl.round_rows, count - rd * pl.round_rows) * k
            got = _copies((bs * r + r0 + rd * pl.round_rows) * k, n)
            assert sorted(got) == list(range(n))
            assert max(at for at, _ in got.values()) < stride
    assert (seen == 1).all()


@pytest.mark.parametrize("p", range(1, MAX_PATHS + 1))
def test_d_pairs_are_each_summed_once(p):
    """The pair decode of D: every (p ≤ q) by one run of threads, each
    through every pilot once by its stride, the run read back in order by the
    thread of the pair's index."""
    pairs = p * (p + 1) // 2
    strides = pg.THREADS // pairs
    got = {}
    for tid in range(pg.THREADS):
        pair, first = divmod(tid, strides)
        pp, rest = 0, pair
        while pp < p and rest >= p - pp:
            rest -= p - pp
            pp += 1
        if pair < pairs:
            assert pp < p and pp <= pp + rest < p
            got.setdefault((pp, pp + rest), []).append(first)
    assert sorted(got) == [(a, c) for a in range(p) for c in range(a, p)]
    assert all(sorted(firsts) == list(range(strides)) for firsts in got.values())


@pytest.mark.parametrize("k", [1, 599, 600, 1024, 2048, 3275, 4096, 5000])
@pytest.mark.parametrize("p", [1, 5, 9])
def test_e_threads_take_each_pilot_once(k, p):
    """The threads of E's sums are (antenna, path, stride), ``strides`` of
    them a path, K's and P's alone: every (antenna, path, pilot) of the most
    antennas a round can hold once, a path's strides read back in order by
    the thread of (antenna, path), and a frame's plan alone (one antenna a
    task) sums in the order of any batch's."""
    most, strides = pg.sums_of(k, p)
    assert most * p * strides <= pg.THREADS < most * p * (strides + 1)
    assert most * k * 8 <= max(pg.STAGE_BYTES, k * 8)
    n = 700
    seen = np.zeros((most, p, n), np.int64)
    for tid in range(pg.THREADS):
        row, path, first = tid // (p * strides), tid // strides % p, tid % strides
        if row < most:
            seen[row, path, first::strides] += 1
            assert tid // strides == row * p + path  # read back from part[(row·P + path)·strides + i]
    assert (seen == 1).all()
    alone, batch = pg.plan_for(1, 14, 64, k, p), pg.plan_for(512, 14, 64, k, p)
    assert alone.strides == batch.strides == strides and alone.chunk == batch.chunk


def test_work_counts():
    nbytes, flops = pg.work(14, 64, 3275, [9] * 64, [4585] * 64)
    assert nbytes == 64 * (8 * 64 * 14 * 3275 + 4 * 14 * 3275) + 64 * (
        16 * 64 * 14 * 9 + 16 * 14 * 81)
    assert round(nbytes / 1e9, 2) == 1.52  # 0.45 ms at 3.35 TB/s
    assert flops == 64 * (8 * 64 * 4585 * 9 + 8 * 4585 * 45)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r,k", [(2, 120), (5, 72)])
def test_kernel_matches_plain(card, r, k):
    """The kernel against its plain version (E to float64 rounding of the
    same float32 quotients, D within the plain tables' float32 products),
    each frame's sums the same bits alone as in its batch, one launch."""
    cfg = _cfg(r=r, k=k)
    args = _args(cfg, _frames(cfg, seed=3, device=card))
    before = profiling.counters.copy()
    e, d = pg.profile_gram(*args)
    moved = {key: n for key, n in (profiling.counters - before).items()
             if key.startswith(("ops.", "mmse_full."))}
    assert moved == {f"ops.profile_gram.{pg.plan(args[0], args[3]).route}": 1,
                     "mmse_full.profile_tables": 1}
    ep, dp = pg.profile_gram_plain(*args)
    assert float((e - ep).abs().max()) <= 1e-6 * _rms(ep)
    assert float((d - dp).abs().max()) <= 1e-6 * _rms(dp)
    rx, tx, mask, tables, pidx = args
    for i in (0, len(CASES) - 1):
        one = pg.profile_gram(rx[i:i + 1], tx[i:i + 1], mask[i:i + 1], tables, pidx[i:i + 1])
        assert torch.equal(one[0][0], e[i]) and torch.equal(one[1][0], d[i])


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(card):
    cfg = _cfg()
    rx, tx, mask, tables, pidx = _args(cfg, _frames(cfg, device=card))
    with pytest.raises(TypeError, match="complex64"):
        pg.profile_gram(rx.to(torch.complex128), tx, mask, tables, pidx)
    with pytest.raises(TypeError, match="float32"):
        pg.profile_gram(rx, tx, mask.double(), tables, pidx)
    wide = torch.zeros(rx.shape[:-1] + (2 * rx.shape[-1],), dtype=rx.dtype, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        pg.profile_gram(wide[..., ::2], tx, mask, tables, pidx)
    with pytest.raises(ValueError, match="different devices"):
        pg.profile_gram(rx.cpu(), tx, mask, tables, pidx)
