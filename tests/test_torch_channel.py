"""The channel and the received grid in one call (``ce5g_torch.ops.channel``).

On the CPU: the plain version gives bit for bit what ``physics.simulate_batch``
computed before the kernel (``mimo.frequency_response``, then
``apply_channel_common_grid`` or ``apply_channel``), on a batch that mixes
EPA, EVA and ETU; its rx equals a float64 formula to float32 rounding; the
route comes from the TX grid's T extent; the wrapper raises on inputs it
does not take; ``simulate_batch`` runs it in one ``physics.channel`` span;
and the kernel's layout, walked in Python as the kernel walks it (the
plan's blocks and tiles, the paired stores at either row alignment), covers
every element once. The tests marked ``cuda`` hold the kernel to the plain
version and to float64 on a card.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from ce5g_torch import ExperimentConfig, MIMOConfig, OFDMConfig
from ce5g_torch.ops import channel as ch
from ce5g_torch.physics import FrameParams, draw_frames, simulate_batch
from ce5g_torch.physics import mimo
from ce5g_torch.physics.profiles import PROFILE_INDEX
from ce5g_torch.physics.simulate import table_for, table_tensors
from ce5g_torch.utils import profiling

CPU = torch.device("cpu")
MIXED = [PROFILE_INDEX[p] for p in ("EPA", "EVA", "ETU")]


def _cfg(r=3, t=2, s=6):
    return ExperimentConfig(
        ofdm=OFDMConfig(fft_size=64, cp_length=8, num_symbols=s, useful_subcarriers=40),
        mimo=MIMOConfig(num_tx=t, num_rx=r),
    )


def _inputs(cfg, per_tx, seed=0, device=CPU):
    """Gains laid out as the Jakes stage returns them (P not innermost), the
    profile table, a mixed batch, a TX grid, SNRs and noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    _, f_table = table_tensors(table_for(cfg), cfg, device)
    b = len(MIXED)
    s, k = cfg.ofdm.num_symbols, cfg.ofdm.num_used_subcarriers
    r, t, p = cfg.mimo.num_rx, cfg.mimo.num_tx, f_table.shape[1]
    raw = torch.randn(b, s, p, r, t, 2, generator=gen, device=device)
    gains = torch.view_as_complex(raw).permute(0, 1, 3, 4, 2)  # (B, S, R, T, P)
    pidx = torch.tensor(MIXED, device=device)
    phase = 6.283185307179586 * torch.rand(b, s, t if per_tx else 1, k, generator=gen,
                                           device=device)
    tx = torch.exp(1j * phase).to(torch.complex64)
    snr = torch.tensor([0.0, 10.0, 25.0], device=device)
    nre = torch.randn(b, s, r, k, generator=gen, device=device)
    nim = torch.randn(b, s, r, k, generator=gen, device=device)
    return gains, f_table, pidx, tx, snr, nre, nim


@pytest.mark.parametrize("per_tx", [False, True])
def test_plain_is_the_former_expression_bit_for_bit(per_tx):
    gains, f_table, pidx, tx, snr, nre, nim = args = _inputs(_cfg(), per_tx)
    h, rx = ch.channel(*args)
    freq_matrix = f_table[pidx]
    want_h = mimo.frequency_response(gains, freq_matrix)
    if per_tx:
        want_rx = mimo.apply_channel(tx, want_h, snr, nre, nim)
    else:
        want_rx = mimo.apply_channel_common_grid(tx[:, :, 0, :], gains, freq_matrix, snr, nre,
                                                 nim)
    assert h.dtype == rx.dtype == torch.complex64
    assert torch.equal(h, want_h) and torch.equal(rx, want_rx)


@pytest.mark.parametrize("per_tx", [False, True])
def test_plain_matches_float64(per_tx):
    """H = Σ_p g·F and rx = y + n·sqrt(P / snr / 2), P the mean |y|² of the
    frame before its noise, in float64 NumPy, to float32 rounding."""
    gains, f_table, pidx, tx, snr, nre, nim = args = _inputs(_cfg(r=4, t=3), per_tx, seed=1)
    h, rx = ch.channel(*args)
    g = gains.numpy().astype(np.complex128)
    f = f_table.numpy().astype(np.complex128)[pidx.numpy()]
    h64 = np.einsum("bsrtp,bpk->bsrtk", g, f)
    x = np.broadcast_to(tx.numpy().astype(np.complex128), h64.shape[:2] + h64.shape[3:])
    y = np.einsum("bsrtk,bstk->bsrk", h64, x)
    power = (np.abs(y) ** 2).mean(axis=(1, 2, 3))
    std = np.sqrt(power / 10.0 ** (snr.numpy().astype(np.float64) / 10.0) / 2.0)
    rx64 = y + (nre.numpy() + 1j * nim.numpy()) * std[:, None, None, None]
    for got, want in ((h, h64), (rx, rx64)):
        err = np.abs(got.numpy() - want).max(axis=tuple(range(1, want.ndim)))
        rms = np.sqrt((np.abs(want) ** 2).mean(axis=tuple(range(1, want.ndim))))
        assert np.all(err <= 1e-6 * rms), err / rms


def test_route_is_the_grid_extent():
    cfg = _cfg(t=4)
    common = _inputs(cfg, per_tx=False)
    per_tx = _inputs(cfg, per_tx=True)
    assert ch.route_of(common[3]) == "common" and ch.route_of(per_tx[3]) == "per_tx"
    assert ch.plan(common[0], common[3]).route == "common"
    assert ch.plan(per_tx[0], per_tx[3]).route == "per_tx"
    # one TX antenna: the grid's extent is 1 either way, and the two sums agree
    one = _inputs(_cfg(t=1), per_tx=True)
    assert ch.route_of(one[3]) == "common"
    h, rx = ch.channel(*one)
    want = mimo.apply_channel(one[3], h, *one[4:])
    torch.testing.assert_close(rx, want, rtol=0, atol=1e-6 * float(want.abs().max()))


def _bad(args, **changes):
    names = ("gains", "f_table", "pidx", "tx", "snr_db", "noise_re", "noise_im")
    out = dict(zip(names, args))
    out.update(changes)
    return [out[n] for n in names]


def test_wrapper_raises_on_what_it_does_not_take():
    args = _inputs(_cfg(t=2), per_tx=False)
    gains, f_table, pidx, tx, snr, nre, nim = args
    b, s, r, t, p = gains.shape
    k = f_table.shape[-1]
    dtypes = [dict(gains=gains.to(torch.complex128)), dict(f_table=f_table.to(torch.complex128)),
              dict(tx=tx.to(torch.complex128)), dict(noise_re=nre.double()),
              dict(noise_im=nim.half()), dict(pidx=pidx.float()), dict(snr_db=snr.to(torch.cfloat)),
              dict(gains=gains.numpy())]
    for change in dtypes:
        with pytest.raises(TypeError):
            ch.channel(*_bad(args, **change))
    shapes = [dict(gains=gains[..., 0]), dict(f_table=f_table[:, :-1]),
              dict(f_table=f_table[..., :-1]), dict(pidx=pidx[:-1]), dict(snr_db=snr[:, None]),
              dict(noise_re=nre[..., :-1]), dict(noise_im=nim[:, :, :1])]
    for change in shapes:
        with pytest.raises(ValueError):
            ch.channel(*_bad(args, **change))
    grids = [tx[:, :, :, None], tx[:-1], tx[..., :-1], tx.expand(b, s, t + 1, k),
             torch.zeros(b, s, t + 1, k, dtype=torch.complex64)]
    for grid in grids:
        with pytest.raises(ValueError, match="TX grid|neither"):
            ch.channel(*_bad(args, tx=grid))
    with pytest.raises(ValueError, match="different devices"):
        ch.channel(*_bad(args, noise_re=torch.empty(nre.shape, device="meta")))
    with pytest.raises(ValueError, match="runs on CPU or CUDA"):
        ch.channel(*(a.to("meta") for a in args))


def test_simulate_batch_runs_one_channel_call():
    cfg = _cfg()
    params = FrameParams(torch.tensor(MIXED, dtype=torch.int32), torch.tensor([10.0, 100.0, 200.0]),
                         torch.tensor([5.0, 15.0, 25.0]), torch.tensor([0.05, 0.10, 0.15]))
    draws = draw_frames(torch.Generator().manual_seed(3), params, cfg, device=CPU)
    before = profiling.counters.copy()
    with profiling.recording() as spans:
        frames = simulate_batch(draws, params, cfg=cfg, device=CPU)
    moved = profiling.counters - before
    parent = [spans[sp.parent].name if sp.parent >= 0 else None for sp in spans]
    chain = [(sp.name, up) for sp, up in zip(spans, parent) if "channel" in sp.name]
    assert chain == [("physics.channel", "physics.simulate"), ("ops.channel", "physics.channel"),
                     ("ops.channel.plain", "ops.channel")]
    assert moved["ops.channel.plain"] == 1 and profiling.launches("channel", moved) == 0
    assert frames.channel.is_contiguous() and frames.rx_symbols.is_contiguous()


# (B, S, R, T, K) of the benchmark's cells: bench_4x4, nr100_4x64, lte_frame_etu300_4x4,
# nr_frame_hst500_4x4
BENCH_SHAPES = ((256, 14, 4, 4, 599), (64, 14, 64, 4, 3275), (512, 140, 4, 4, 599),
                (128, 280, 4, 4, 611))


@pytest.mark.parametrize("shape", BENCH_SHAPES)
@pytest.mark.parametrize("route", ch.ROUTES)
def test_plan_fits_the_kernel(shape, route):
    b, s, r, t, k = shape
    pl = ch.plan_for(b, s, r, t, k, route)
    assert pl.route == route and pl.threads % 32 == 0 and 32 <= pl.threads <= 256
    pairs = -(-k // 2)
    assert pl.tiles * pl.threads >= pairs > (pl.tiles - 1) * pl.threads
    assert pl.group * t * 8 * ch.MAX_KERNEL_PATHS <= ch.MAX_STAGED
    assert pl.group * t <= ch.BLOCK_ROWS and pl.chunks == -(-(s * r) // pl.group)
    assert pl.grid == b * pl.chunks * pl.tiles < 2 ** 31
    # few idle threads along K: 128 threads × 13 tiles at K = 3275, 160 × 2 at 599 and 611
    assert (pl.threads, pl.tiles) == {599: (160, 2), 611: (160, 2), 3275: (128, 13)}[k]


def _stores(k, threads, tiles, odd):
    """The elements of one row of K that the kernel's paired stores write
    (csrc/channel.cu ``store_pair``), each as often as it is written: a row
    that starts on a 16-byte boundary (``odd`` False) or 8 bytes off one."""
    hits = np.zeros(k, np.int64)
    for m in range(threads * tiles):
        lane, k0 = m % 32, 2 * m
        if not odd:
            for e in ((k0, k0 + 1) if k0 + 1 < k else (k0,) if k0 < k else ()):
                hits[e] += 1
            continue
        if lane == 0 and k0 < k:
            hits[k0] += 1
        if k0 + 1 < k:
            hits[k0 + 1] += 1
            if lane < 31 and k0 + 2 < k:
                hits[k0 + 2] += 1
    return hits


@pytest.mark.parametrize("k", [1, 2, 31, 63, 64, 65, 599, 600, 3275])
def test_paired_stores_write_each_element_once(k):
    pl = ch.plan_for(1, 1, 1, 1, k, "common")
    for odd in (False, True):
        assert (_stores(k, pl.threads, pl.tiles, odd) == 1).all(), (k, odd)


@pytest.mark.parametrize("shape", [(3, 6, 3, 2, 39), (2, 14, 64, 4, 599), (1, 140, 4, 4, 599),
                                   (2, 5, 7, 1, 65)])
def test_blocks_cover_every_row_once(shape):
    """Block i takes tile i % tiles of group (i // tiles) % chunks of frame
    i // (tiles · chunks) (``block_of``): every (frame, s, r, subcarrier pair)
    once, and block i's partial belongs to its own frame."""
    b, s, r, t, k = shape
    pl = ch.plan_for(b, s, r, t, k, "common")
    seen = np.zeros((b, s * r, pl.tiles * pl.threads), np.int64)
    for i in range(pl.grid):
        tile, rest = i % pl.tiles, i // pl.tiles
        sr0, frame = (rest % pl.chunks) * pl.group, rest // pl.chunks
        rows = min(pl.group, s * r - sr0)
        assert rows >= 1 and i // (pl.chunks * pl.tiles) == frame
        seen[frame, sr0:sr0 + rows, tile * pl.threads:(tile + 1) * pl.threads] += 1
    assert (seen == 1).all()


def test_kernel_holds_the_tables_paths():
    """The kernel keeps MAX_KERNEL_PATHS paths in registers, as many as every
    profile table has; more raise on the card before any launch."""
    from ce5g_torch.physics.profiles import MAX_PATHS

    assert ch.MAX_KERNEL_PATHS == MAX_PATHS
    src = (Path(ch.__file__).resolve().parent.parent / "csrc" / "channel.cu").read_text()
    assert f"constexpr int kMaxPaths = {MAX_PATHS};" in src
    assert table_tensors(table_for(_cfg()), _cfg(), CPU)[1].shape[1] == MAX_PATHS


def test_work_counts():
    gains = torch.zeros(64, 14, 64, 4, 9, dtype=torch.complex64)
    grid = torch.zeros(64, 14, 4, 3275, dtype=torch.complex64)[:, :, :1]
    nbytes, flops = ch.work(gains, grid)
    srk, srtk = 14 * 64 * 3275, 14 * 64 * 4 * 3275
    assert nbytes == 64 * (8 * srtk + 16 * srk + 8 * 14 * 3275)
    assert round(nbytes / 1e9, 2) == 9.04  # 2.70 ms at 3.35 TB/s
    assert flops == 64 * (72 * srtk + 2 * 3 * 9 * 14 * 64 + 86 * srk)
    # a grid broadcast along TX is read by its distinct values
    assert ch.work(gains, grid.expand(64, 14, 4, 3275))[0] == nbytes


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().pow(2).mean().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("per_tx", [False, True])
@pytest.mark.parametrize("s,r,t", [(6, 2, 4), (14, 3, 1)])
def test_kernel_matches_plain(card, per_tx, s, r, t):
    args = _inputs(_cfg(r=r, t=t, s=s), per_tx, seed=4, device=card)
    before = profiling.counters.copy()
    h, rx = ch.channel(*args)
    moved = {k: n for k, n in (profiling.counters - before).items() if k.startswith("ops.")}
    assert moved == {f"ops.channel.{ch.route_of(args[3])}": 1}
    hp, rxp = ch.channel_plain(*args)
    assert _rel(h, hp) <= 3e-6 and _rel(rx, rxp) <= 3e-6  # chip_smoke's CHANNEL_*_LIMIT
    again = ch.channel(*args)
    assert torch.equal(h, again[0]) and torch.equal(rx, again[1])


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(card):
    args = _inputs(_cfg(), per_tx=False, device=card)
    with pytest.raises(TypeError, match="complex64"):
        ch.channel(args[0].to(torch.complex128), *args[1:])
    with pytest.raises(ValueError, match="different devices"):
        ch.channel(args[0].cpu(), *args[1:])
