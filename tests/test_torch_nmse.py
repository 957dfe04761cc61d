"""The score's reduction (``ce5g_torch.ops.nmse``) and ``utils.metrics.nmse``.

On the CPU: the plain expression against the JAX package's ``nmse`` on the
same numpy inputs, the plan's layout read back through its strides against
a float64 reduction (every element in its output row, the repeat axis
along Ĥ's broadcast), its work items walked as the kernel walks them (each
element read once), and the work count. The tests marked ``cuda`` hold
the kernel to a float64 reduction of the same tensors and need a card;
JAX is imported only inside the CPU tests.
"""
import math

import numpy as np
import pytest
import torch

from ce5g_torch.ops import nmse as nmse_mod
from ce5g_torch.utils import metrics, profiling

RESIDENT = 132 * 4  # blocks an H100 keeps resident (the plan's grid; any number will do)
PER_FRAME = (1, 2, 3, 4)


def _inputs(seed, b, s, r, t, k):
    """H (B, S, R, T, K) and Ĥ's distinct values (B, R, S, K), complex64."""
    rng = np.random.default_rng(seed)

    def cn(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    h = cn(b, s, r, t, k)
    e = (h[:, :, :, 0].transpose(0, 2, 1, 3) + 0.3 * cn(b, r, s, k)).astype(np.complex64)
    return h, e


def _ls_view(e: torch.Tensor, t: int) -> torch.Tensor:
    """The estimators' Ĥ: (B, R, S, K) transposed to (B, S, R, K) and
    broadcast along T (estimators/ls.py:78-80)."""
    v = e.transpose(1, 2)
    b, s, r, k = v.shape
    return v[:, :, :, None, :].expand(b, s, r, t, k)


def _mmse_view(e: torch.Tensor, t: int) -> torch.Tensor:
    """Ĥ as mmse_full returns it: a contiguous (B, S, R, K) broadcast along T."""
    v = e.transpose(1, 2).contiguous()
    b, s, r, k = v.shape
    return v[:, :, :, None, :].expand(b, s, r, t, k)


def _sums64(h, e, axes=None):
    """Σ|H − Ĥ|² and Σ|H|² in float64."""
    h, e = h.to(torch.complex128), e.to(torch.complex128)
    dims = tuple(range(h.ndim)) if axes is None else tuple(axes)
    return ((h - e).abs() ** 2).sum(dim=dims), (h.abs() ** 2).sum(dim=dims)


def _nmse64(h, e, axes=None):
    err, pwr = _sums64(h, e, axes)
    n = h.numel() // max(err.numel(), 1)
    return (err / n) / (pwr / n + 1e-12)


def _by_plan(pl, h, e):
    """The two float64 sums of each output row, read through the plan's
    sizes and strides alone."""
    sizes = [d[0] for d in pl.outer] + [pl.rep[0], pl.inner[0]]
    hv = torch.as_strided(h, sizes, [d[1] for d in pl.outer] + [pl.rep[1], pl.inner[1]],
                          h.storage_offset())
    ev = torch.as_strided(e, sizes, [d[2] for d in pl.outer] + [0, pl.inner[2]],
                          e.storage_offset())
    assert hv.numel() == pl.rows * pl.elements
    hv, ev = hv.to(torch.complex128), ev.to(torch.complex128)
    err = ((hv - ev).abs() ** 2).reshape(pl.rows, -1).sum(1)
    pwr = (hv.abs() ** 2).reshape(pl.rows, -1).sum(1)
    return err.reshape(pl.out_shape), pwr.reshape(pl.out_shape)


def _plan(h, e, axes=None, resident=RESIDENT):
    e = e.expand(h.shape)
    return nmse_mod.plan_for(tuple(h.shape), h.stride(), e.stride(),
                             nmse_mod._axes(axes, h.ndim), resident)


def _by_items(pl, h, e):
    """The two float64 sums of each output row, the work items walked as
    the kernel walks them (each item's run of pieces, a piece a stretch of
    a line's inner axis), every element read counted."""
    sizes = [d[0] for d in pl.outer] + [pl.rep[0], pl.inner[0]]
    hv = torch.as_strided(h, sizes, [d[1] for d in pl.outer] + [pl.rep[1], pl.inner[1]],
                          h.storage_offset())
    ev = torch.as_strided(e, sizes, [d[2] for d in pl.outer] + [0, pl.inner[2]],
                          e.storage_offset())
    k = pl.inner[0]
    hv = hv.to(torch.complex128).reshape(pl.rows, pl.lines_per_row, pl.rep[0], k)
    ev = ev.to(torch.complex128).reshape(pl.rows, pl.lines_per_row, pl.rep[0], k)
    reads = torch.zeros(pl.rows, pl.lines_per_row, k, dtype=torch.int64)
    err = torch.zeros(pl.rows, dtype=torch.float64)
    pwr = torch.zeros(pl.rows, dtype=torch.float64)
    per_row = pl.lines_per_row * pl.pieces
    for w in range(pl.rows * pl.chunks):
        row, c = divmod(w, pl.chunks)
        first, last = c * per_row // pl.chunks, (c + 1) * per_row // pl.chunks
        assert first < last  # every work item has a piece
        for l in range(first, last):
            line, p = divmod(l, pl.pieces)
            span = slice(p * pl.piece, min(k, (p + 1) * pl.piece))
            reads[row, line, span] += 1
            hs, es = hv[row, line, :, span], ev[row, line, :, span]
            err[row] += ((hs - es).abs() ** 2).sum()
            pwr[row] += (hs.abs() ** 2).sum()
    assert bool((reads == 1).all())
    return err.reshape(pl.out_shape), pwr.reshape(pl.out_shape)


@pytest.mark.parametrize("axes", [None, PER_FRAME, (-1,)])
def test_plain_and_metrics_match_jax(axes):
    from ce5g_tpu.utils import metrics as jax_metrics

    h, e = _inputs(3, 2, 6, 2, 2, 39)
    e5 = np.broadcast_to(e.transpose(0, 2, 1, 3)[:, :, :, None, :], h.shape)
    want = np.asarray(jax_metrics.nmse(h, e5, axes))
    ht, et = torch.from_numpy(h), _ls_view(torch.from_numpy(e), 2)
    for got in (nmse_mod.nmse_plain(ht, et, axes), metrics.nmse(ht, et, axes)):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)


@pytest.mark.parametrize("axes", [None, PER_FRAME])
def test_plain_is_the_former_expression(axes):
    """The CPU path computes, bit for bit, the score's former expression."""
    h, e = _inputs(4, 3, 4, 2, 2, 23)
    ht, et = torch.from_numpy(h), _ls_view(torch.from_numpy(e), 2)
    pwr = ht.abs() ** 2
    p = pwr.mean() if axes is None else pwr.mean(dim=tuple(axes))
    err = (ht - et).abs() ** 2
    m = err.mean() if axes is None else err.mean(dim=tuple(axes))
    former = m / (p + 1e-12)
    assert torch.equal(nmse_mod.nmse_plain(ht, et, axes), former)
    assert torch.equal(metrics.nmse(ht, et, axes), former)


def test_cpu_takes_the_plain_version():
    h, e = _inputs(5, 1, 2, 2, 2, 9)
    before = profiling.counters.copy()
    metrics.nmse(torch.from_numpy(h), _ls_view(torch.from_numpy(e), 2))
    moved = profiling.counters - before
    assert moved == {"ops.nmse.plain": 1} and profiling.launches("nmse", moved) == 0


def test_work_counts_h_and_the_distinct_estimate():
    b, s, r, t, k = 2, 3, 4, 5, 7
    h = torch.zeros(b, s, r, t, k, dtype=torch.complex64)
    e = torch.zeros(b, r, s, k, dtype=torch.complex64)
    for view in (_ls_view(e, t), _mmse_view(e, t)):
        assert nmse_mod.work(h, view) == (8 * b * s * r * t * k + 8 * b * s * r * k,
                                          10 * b * s * r * t * k)
    # an estimate with no broadcast axis is read whole
    assert nmse_mod.work(h, h.clone())[0] == 16 * h.numel()
    # broadcast by shape rather than by stride counts the same
    assert nmse_mod.work(h, e.transpose(1, 2)[:, :, :, None, :]) == nmse_mod.work(h, _ls_view(e, t))


LAYOUTS = {
    "ls": lambda e, t: _ls_view(e, t),
    "mmse_full": lambda e, t: _mmse_view(e, t),
    "whole": lambda e, t: _ls_view(e, t).contiguous(),
    "short": lambda e, t: e.transpose(1, 2)[:, :, :, None, :],  # broadcast by shape
    "offset": lambda e, t: _ls_view(e[..., 1:], t),  # rows start 8 bytes off 16
}
AXES = [None, PER_FRAME, (4,), (0,), (1, 3), (-1, -2), (3,), ()]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("axes", AXES)
def test_plan_reads_every_element_once(layout, axes):
    """Read back through the plan's strides, the layout sums exactly the
    elements of each output row that the plain expression does."""
    b, s, r, t, k = 2, 3, 4, 3, 11
    h, e = _inputs(6, b, s, r, t, k)
    ht = torch.from_numpy(h)
    if layout == "offset":
        ht = ht[..., 1:]
    et = LAYOUTS[layout](torch.from_numpy(e), t)
    pl = _plan(ht, et, axes)
    err, pwr = _by_plan(pl, ht, et.expand(ht.shape))
    ax = nmse_mod._axes(axes, ht.ndim)
    want_err, want_pwr = _sums64(ht, et.expand(ht.shape), ax)
    assert tuple(err.shape) == tuple(want_err.shape) == pl.out_shape
    torch.testing.assert_close(err, want_err, rtol=1e-12, atol=0)
    torch.testing.assert_close(pwr, want_pwr, rtol=1e-12, atol=0)
    assert pl.rows * pl.elements == ht.numel()
    assert pl.chunks >= 1 and 1 <= pl.grid <= RESIDENT and pl.team in (32, 64, 128, 256)


@pytest.mark.parametrize("t", [3, 1])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("axes, k", [(None, 700), (PER_FRAME, 700), ((0,), 40)])
@pytest.mark.parametrize("resident", [1, 7, RESIDENT])
def test_work_items_read_every_element_once(layout, t, axes, k, resident):
    """Walked as the kernel walks its work items and their pieces, the plan
    reads each element once and sums what the plain expression does. (Over
    the frame axis alone every element of a frame is an output row: a
    short K keeps the walk's rows few.)"""
    b, s, r = 2, 3, 4
    h, e = _inputs(13, b, s, r, t, k)
    ht = torch.from_numpy(h)
    if layout == "offset":
        ht = ht[..., 1:]
    et = LAYOUTS[layout](torch.from_numpy(e), t)
    pl = _plan(ht, et, axes, resident)
    err, pwr = _by_items(pl, ht, et.expand(ht.shape))
    want_err, want_pwr = _sums64(ht, et.expand(ht.shape), nmse_mod._axes(axes, ht.ndim))
    torch.testing.assert_close(err, want_err, rtol=1e-12, atol=0)
    torch.testing.assert_close(pwr, want_pwr, rtol=1e-12, atol=0)
    assert pl.piece * (pl.pieces - 1) < pl.inner[0] <= pl.piece * pl.pieces
    if pl.pieces > 1:  # whole passes of a team: on 'pairs' each piece keeps its row's parity
        assert pl.piece % (pl.team * (2 if pl.route == "pairs" else 1)) == 0
    step = pl.team * (2 if pl.route == "pairs" else 1)
    fewer = pl.rows * pl.lines_per_row < resident * (256 // pl.team)  # lines than teams
    assert (pl.pieces > 1) == (fewer and pl.inner[0] >= 2 * step)


def test_plan_gives_every_team_work():
    """At the benchmark's shapes with a contiguous Ĥ, and with one TX
    antenna (T = 1), everything merges into few long lines; cut into
    pieces, they still give nearly every team of the resident grid one
    work item of many pieces."""
    for b, s, r, t, k in ((64, 14, 64, 4, 3275), (256, 14, 4, 4, 599)):
        for tt in (t, 1):
            hs = (s * r * tt * k, r * tt * k, tt * k, k, 1)
            mm = (s * r * k, r * k, k, 0, 1)  # contiguous (B, S, R, K) broadcast along T
            for es in ((hs, mm) if tt == 1 else (hs,)):
                for axes in (None, PER_FRAME):
                    pl = nmse_mod.plan_for((b, s, r, tt, k), hs, es, axes, RESIDENT)
                    per_block = 256 // pl.team
                    assert pl.pieces > 1
                    # at least 95% of the resident grid's teams take a work item, none two
                    assert 0.95 * RESIDENT * per_block <= pl.rows * pl.chunks <= (
                        RESIDENT * per_block)
                    assert pl.grid == -(-pl.rows * pl.chunks // per_block)
                    # ≥ 16 pieces an item: the longest item within 1/16 of the mean
                    assert pl.lines_per_row * pl.pieces >= 16 * pl.chunks
                    assert 16 * pl.partials < 2 ** 20


def test_plan_of_the_benchmark_shapes():
    """At the benchmark's shapes the estimate's TX axis is the repeat axis,
    read from device memory once, and the rows take the 16-byte route."""
    for b, s, r, t, k in ((64, 14, 64, 4, 3275), (256, 14, 4, 4, 599)):
        hs = (s * r * t * k, r * t * k, t * k, k, 1)
        ls = (r * s * k, k, s * k, 0, 1)  # (B, R, S, K) transposed, broadcast along T
        mm = (s * r * k, r * k, k, 0, 1)  # contiguous (B, S, R, K), broadcast along T
        for es, outer in ((ls, ((b, s * r * t * k, r * s * k), (s, r * t * k, k),
                                (r, t * k, s * k))),
                          (mm, ((b * s * r, t * k, k),))):
            pl = nmse_mod.plan_for((b, s, r, t, k), hs, es, None, RESIDENT)
            assert pl.route == "pairs" and pl.rep == (t, k) and pl.inner == (k, 1, 1)
            assert pl.pieces == 1  # enough lines: a line is not cut
            assert pl.outer == outer and pl.rows == 1 and pl.lines_per_row == b * s * r
            assert pl.chunks * (256 // pl.team) >= RESIDENT  # every team of the grid has work
            assert 16 * pl.partials < 2 ** 20  # the scratch stays small
            assert pl.team == {3275: 128, 599: 32}[k]  # ≥ 8 passes of a team over a row
        per_frame = nmse_mod.plan_for((b, s, r, t, k), hs, ls, PER_FRAME, RESIDENT)
        assert per_frame.rows == b and per_frame.out_shape == (b,)


def test_plan_rejects_bad_axes():
    h = torch.zeros(2, 3, 4, dtype=torch.complex64)
    with pytest.raises(IndexError):
        _plan(h, h, (3,))
    with pytest.raises(ValueError, match="twice"):
        _plan(h, h, (1, -2))
    assert _plan(h, h, ()) == _plan(h, h, None)


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_inputs(card, seed, b, s, r, t, k):
    h, e = _inputs(seed, b, s, r, t, k)
    return torch.from_numpy(h).to(card), torch.from_numpy(e).to(card)


def _sums(h, e, axes=None):
    """The kernel's float64 sums Σ|H − Ĥ|², Σ|H|² over ``axes``."""
    e = e.expand(h.shape)
    sums = nmse_mod._launch(nmse_mod.plan(h, e, axes), h, e)[1]
    return sums[..., 0], sums[..., 1]


def _held_to_float64(h, e, axes=None):
    err, pwr = _sums(h, e, axes)
    want_err, want_pwr = _sums64(h, e.expand(h.shape), nmse_mod._axes(axes, h.ndim))
    torch.testing.assert_close(err, want_err, rtol=1e-6, atol=0)
    torch.testing.assert_close(pwr, want_pwr, rtol=1e-6, atol=0)
    got = nmse_mod.nmse(h, e, axes)
    assert got.dtype == torch.float32 and got.device == h.device
    want = _nmse64(h, e.expand(h.shape), nmse_mod._axes(axes, h.ndim))
    torch.testing.assert_close(got.double(), want, rtol=3e-7, atol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_matches_float64(card, layout):
    b, s, r, t, k = 4, 14, 8, 4, 599
    h, e = _card_inputs(card, 7, b, s, r, t, k)
    if layout == "offset":
        h = h[..., 1:]
    _held_to_float64(h, LAYOUTS[layout](e, t))


@pytest.mark.cuda
@pytest.mark.parametrize("axes", AXES)
def test_kernel_over_axes_matches_float64(card, axes):
    h, e = _card_inputs(card, 8, 3, 14, 4, 4, 599)
    _held_to_float64(h, _ls_view(e, 4), axes)


@pytest.mark.cuda
@pytest.mark.parametrize("axes", [None, PER_FRAME])
def test_kernel_one_antenna_matches_float64(card, axes):
    """T = 1 (SIMO): H and a contiguous Ĥ merge into one long line."""
    h, e = _card_inputs(card, 14, 4, 14, 8, 1, 599)
    pl = nmse_mod.plan(h, _mmse_view(e, 1), axes)
    assert pl.pieces > 1 and pl.rows * pl.chunks >= pl.grid * (256 // pl.team)
    _held_to_float64(h, _mmse_view(e, 1), axes)


@pytest.mark.cuda
def test_kernel_counts_one_call_and_no_plain(card):
    h, e = _card_inputs(card, 9, 2, 14, 4, 4, 599)
    before = profiling.counters.copy()
    metrics.nmse(h, _ls_view(e, 4))
    moved = profiling.counters - before
    assert moved == {"ops.nmse.pairs": 1}
    # on the card the kernel takes the input or the call raises: no plain version runs there
    before = profiling.counters.copy()
    with pytest.raises(TypeError, match="complex64"):
        metrics.nmse(h.to(torch.complex128), _ls_view(e, 4).to(torch.complex128))
    with pytest.raises(TypeError, match="gradient"):
        metrics.nmse(h.clone().requires_grad_(), _ls_view(e, 4))
    with pytest.raises(ValueError, match="broadcast"):
        metrics.nmse(h[:1], _ls_view(e, 4))
    with pytest.raises(ValueError, match="cpu"):
        metrics.nmse(h, _ls_view(e, 4).cpu())
    assert profiling.counters - before == {}


@pytest.mark.cuda
def test_evaluate_estimator_takes_one_kernel_call(card):
    h, e = _card_inputs(card, 15, 2, 14, 4, 4, 599)
    view = _ls_view(e, 4)
    before = profiling.counters.copy()
    got = metrics.evaluate_estimator(h, view)
    assert profiling.counters - before == {"ops.nmse.pairs": 1}
    err, _ = _sums64(h, view.expand(h.shape))
    assert got["mse"].dtype == got["nmse"].dtype == torch.float32
    torch.testing.assert_close(got["mse"].double(), err / h.numel(), rtol=3e-7, atol=0)
    assert torch.equal(got["nmse"], metrics.nmse(h, view))


@pytest.mark.cuda
def test_kernel_is_bitwise_repeatable(card):
    h, e = _card_inputs(card, 10, 8, 14, 16, 4, 3275)
    view = _ls_view(e, 4)
    first, again = _sums(h, view), _sums(h, view)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(nmse_mod.nmse(h, view, PER_FRAME), nmse_mod.nmse(h, view, PER_FRAME))


@pytest.mark.cuda
def test_kernel_past_two_gib(card):
    """An H of more than 2³¹ bytes: the offsets are 64-bit."""
    b, s, r, t, k = 23, 14, 64, 4, 3275
    assert 8 * b * s * r * t * k > 2 ** 31
    gen = torch.Generator(device=card).manual_seed(11)
    h = torch.randn(b, s, r, t, k, dtype=torch.complex64, device=card, generator=gen)
    e = torch.randn(b, r, s, k, dtype=torch.complex64, device=card, generator=gen)
    view = _ls_view(e, t)
    err, pwr = _sums(h, view, PER_FRAME)
    for i in range(b):  # float64 a frame at a time
        want_err, want_pwr = _sums64(h[i], view[i])
        torch.testing.assert_close(err[i], want_err, rtol=1e-6, atol=0)
        torch.testing.assert_close(pwr[i], want_pwr, rtol=1e-6, atol=0)
    total = nmse_mod.nmse(h, view)
    want = (err.sum() / h.numel()) / (pwr.sum() / h.numel() + 1e-12)
    torch.testing.assert_close(total.double(), want, rtol=3e-7, atol=0)


@pytest.mark.cuda
def test_kernel_zero_channel_and_nan(card):
    h, e = _card_inputs(card, 12, 2, 14, 4, 4, 599)
    zero = torch.zeros_like(h)
    assert float(nmse_mod.nmse(zero, _ls_view(torch.zeros_like(e), 4))) == 0.0
    got = nmse_mod.nmse(zero, _ls_view(e, 4))  # ε alone below the error
    torch.testing.assert_close(got, nmse_mod.nmse_plain(zero, _ls_view(e, 4)), rtol=1e-5, atol=0)
    assert math.isfinite(float(got)) and float(got) > 1e12
    for bad in (float("nan"), float("inf")):
        hb = h.clone()
        hb[1, 3, 2, 1, 100] = bad
        per_frame = nmse_mod.nmse(hb, _ls_view(e, 4), PER_FRAME)
        plain = nmse_mod.nmse_plain(hb, _ls_view(e, 4), PER_FRAME)
        assert bool(torch.isnan(nmse_mod.nmse(hb, _ls_view(e, 4))))
        assert bool(torch.isnan(per_frame[1])) and bool(torch.isnan(plain[1]))
        assert bool(torch.isfinite(per_frame[0]))
