"""The kernels' envelope: shapes past the H100 kernels' former limits.

More than 8 receive antennas, 140 symbols (an LTE radio frame), a 100 MHz
NR carrier (273 PRB at 30 kHz, K = 3275), valid slots that share a
resource element and HPD systems past n = 128 run through the same
wrappers as the bench shapes. On the CPU each wrapper runs
its plain version, so these tests hold:

* the host's launch plans (``plan()`` of each kernel module, pure Python):
  every plan fits a block's 232 448 bytes of shared memory and covers every
  antenna and column once, the slot kernel's tiles stage no more sorted
  pilots than planned on real pilot patterns, and a tile whose pilots
  pass its plan is split into passes that each fit;
* the plain versions against the JAX package on the new hard cases
  (interpolation within 1e-5 absolute, the JAX package's XLA branch);
* the whole slice at the three envelope configurations (4×12 at 14 × 599;
  4×4 on the NR carrier; 4×4 ETU 300 Hz over one LTE radio frame of 140
  symbols, where mmse_full solves n = 171): ``ls`` and ``ls:cubic`` within 1e-5 of the JAX
  package's rms, ``mmse_full`` within 1e-5 of the rms of the port's own
  float64 run, every NMSE within 0.01 dB of the JAX package's.

The tests marked ``cuda`` hold each kernel, by each of its routes (forced
through the module's private ``_launch`` with a plan of that route),
against its plain version on the same cases; they skip without a card.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ce5g_torch.ops import hard_cases
from ce5g_torch.ops import hpd_solve as hpd_mod
from ce5g_torch.ops import interp as slot_mod
from ce5g_torch.ops import interp_fused as grid_mod
from ce5g_torch.utils import profiling

from _torch_parity import jax_params, port_cfg, simulate_both

MAX_SMEM = 232448  # dynamic shared memory a block may use on the H100
DEFAULT_SMEM = 49152  # what a launch may use without raising its limit
CANDIDATES = 128


def _covered_once(ranges, n):
    """The (first, count) ranges cover 0 … n − 1, each index once."""
    got = sorted(i for first, count in ranges for i in range(first, first + count))
    assert got == list(range(n)), ranges


@pytest.mark.parametrize("k", (599, 3275, 3300))
@pytest.mark.parametrize("s", (1, 14, 127, 128, 140))
@pytest.mark.parametrize("r", (1, 2, 4, 8, 9, 16, 64))
def test_plans_fit_and_cover(r, s, k):
    grid = grid_mod.plan(r, s, k)
    assert grid.route == ("shared" if grid.smem else "global")
    assert grid.smem <= MAX_SMEM and grid.cand_smem <= DEFAULT_SMEM
    assert grid.tile <= 128
    _covered_once(grid.columns(k), k)
    _covered_once(grid.antennas, r)
    for density in (0.01, 0.10, 0.15, 0.25):
        p = max(1, math.ceil(density * s * k))
        slot = slot_mod.plan(r, p, s, k)
        assert slot.smem <= MAX_SMEM and slot.sort_smem <= DEFAULT_SMEM
        _covered_once(slot.columns(k), k)
        _covered_once(slot.antennas, r)
        if slot.route == "frame":
            assert r <= 8 and (slot.tiles, slot.tile) == (1, k)
        else:  # the union of a tile's windows
            assert slot.cap >= min(p, s * (slot.tile - 1) + min(CANDIDATES, p))
            assert 2 * slot.smem <= MAX_SMEM
    for n in (1, 45, 75, 126, 128, 129, 135, 160, 171, 243, 300, 376, 384, 400):
        hpd = hpd_mod.plan(n, r)
        if n <= hpd_mod.MAX_N:
            assert hpd.route == "registers"
        else:  # a cluster of 8 holds n + R ≤ 384 (R ≤ 8 riding)
            assert hpd.route == ("cluster" if n + min(r, hpd_mod.RIDE_R) <= CLUSTER_ROWS
                                 else "blocked")
        if hpd.route == "cluster":
            _cluster_plan_holds(hpd, n, r)
            continue
        assert hpd.smem <= (MAX_SMEM if hpd.route == "registers" else DEFAULT_SMEM)
        _covered_once([(0, hpd.ride)] + [(c, 1) for cols in hpd.columns for c in cols], r)


CLUSTER_ROWS = 384  # the trapezoid rows, n + R, that a cluster of 8 holds in registers
CLUSTER_ELEMENTS = 56  # the most elements of the trapezoid a thread holds


def _elements(blocks, na, nb):
    """Elements a thread of the cluster kernel holds: (a, b) for b < C·(a + 1)."""
    return sum(min(blocks * (a + 1), nb) for a in range(na))


def _cluster_plan_holds(pl, n, r):
    """A 'cluster' plan fits a block's shared memory, its instance exists and
    holds every row of the trapezoid, the grid is a whole number of
    clusters, each row of the factor is kept by exactly one block for the
    backward substitution, each row of the elimination is owned by
    exactly one thread of the cluster, and the chunks cover R once."""
    blocks, na, nb = pl.instance
    assert pl.blocks == blocks in hpd_mod.CLUSTER_SIZES and pl.instance in hpd_mod.CLUSTER_INSTANCES
    assert pl.smem <= MAX_SMEM
    assert _elements(blocks, na, nb) <= CLUSTER_ELEMENTS
    assert 16 * nb >= n and 16 * blocks * na >= n + pl.ride
    for b in (1, 32, 37):
        grid = pl.grid(b)
        assert grid[0] % blocks == 0 and grid[0] // blocks == b and grid[1] == pl.chunks
    assert len(pl.rows) == blocks
    _covered_once(pl.rows, n)
    owners = [q + blocks * ri + 16 * blocks * a for q in range(blocks) for ri in range(16)
              for a in range(na)]
    _covered_once([(i, 1) for i in owners if i < n + pl.ride], n + pl.ride)
    _covered_once([(hpd_mod.RIDE_R * k, min(hpd_mod.RIDE_R, r - hpd_mod.RIDE_R * k))
                   for k in range(pl.chunks)], r)
    assert pl.ride == min(r, hpd_mod.RIDE_R)


@pytest.mark.parametrize("r", (1, 4, 8, 9, 16, 64))
@pytest.mark.parametrize("n", (129, 135, 144, 160, 171, 192, 224, 243, 256, 300))
def test_hpd_cluster_plans(n, r):
    """Every cluster size with an instance for (n, R) gives a plan that
    holds; plan() picks one of them."""
    held = []
    for blocks in hpd_mod.CLUSTER_SIZES:
        try:
            pl = hpd_mod._plan(n, r, blocks)
        except ValueError:
            continue
        _cluster_plan_holds(pl, n, r)
        held.append(pl)
    assert hpd_mod.plan(n, r) in held


def test_hpd_cluster_instances_match_the_source():
    """The instances compiled in csrc/hpd_solve.cu are the ones plan()
    knows, in its order, each within a thread's registers and a block's
    shared memory at the largest system it takes, its column buffer
    holding every column index it reads."""
    import re
    from pathlib import Path

    src = (Path(hpd_mod.__file__).parent.parent / "csrc" / "hpd_solve.cu").read_text()
    macro = src[src.index("#define HPD_CLUSTER_INSTANCES(X)"):].split("\n\n")[0]
    listed = tuple(tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", macro))
    assert listed == hpd_mod.CLUSTER_INSTANCES
    for blocks, na, nb in listed:
        assert _elements(blocks, na, nb) <= CLUSTER_ELEMENTS and blocks * na >= nb
        n = min(16 * nb, 16 * blocks * na - 1)
        assert hpd_mod._plan(n, 1, blocks).smem <= MAX_SMEM


def test_routes_by_shape():
    """The main path's shapes take the grid form's 'shared' route and the
    slot form's 'frame' route; more antennas, or a frame too large for a
    block, take the slot form's 'tile' route; mmse_full over 140 symbols
    at 200 and 300 Hz (time rank 15 and 19, n = 135 and 171) takes the
    HPD cluster kernel, a system past its instances the blocked one."""
    assert grid_mod.plan(4, 14, 599).route == "shared"
    assert grid_mod.plan(8, 127, 599).route == "shared"
    assert slot_mod.plan(4, 2096, 14, 599).route == "frame"
    assert slot_mod.plan(2, 2096, 14, 599).route == "frame"
    assert slot_mod.plan(9, 2096, 14, 599).route == "tile"
    assert slot_mod.plan(4, 6878, 14, hard_cases.NR_K).route == "tile"
    assert hpd_mod.plan(45, 4).route == "registers"
    assert hpd_mod.plan(9 * 15, 4).route == "cluster"
    assert hpd_mod.plan(9 * 19, 4).route == "cluster"
    assert hpd_mod.plan(400, 4).route == "blocked"
    with pytest.raises(ValueError, match="S² \\+ K²"):
        slot_mod.plan(4, 100, 14, 5000)


def _tile_unions(positions, valid, s, k, tile):
    """Sorted pilots each tile of ``tile`` columns stages: the union of its
    columns' windows, from the XLA branch's window starts."""
    c = min(CANDIDATES, valid.shape[-1])
    out = []
    for pos, ok in zip(positions, valid):
        cols = np.sort(pos[ok > 0, 1])
        n_valid = cols.size
        start = np.clip(np.searchsorted(cols, np.arange(k), side="left") - c // 2, 0,
                        max(n_valid - c, 0))
        n_c = min(c, n_valid)
        for k0 in range(0, k, tile):
            k1 = min(k0 + tile, k) - 1
            out.append(start[k1] + n_c - start[k0])
    return np.array(out)


@pytest.mark.parametrize("case", ["past_cap", "s140", "scattered_nr_25", "scattered_140"])
def test_slot_tiles_stage_what_the_plan_holds(case):
    if case.startswith("scattered"):
        from ce5g_torch.physics.pilots import scattered_pattern

        s, k, density = (14, hard_cases.NR_K, 0.25) if case.endswith("25") else (140, 599, 0.10)
        u = torch.from_numpy(np.random.default_rng(7).random((2, s * k), dtype=np.float32))
        pat = scattered_pattern(u, s, k, density, 0.25)
        positions, valid = pat.positions.numpy(), pat.valid.numpy()
    else:
        c = hard_cases.slot_case(case)
        positions, valid, (s, k) = c["positions"].numpy(), c["valid"].numpy(), c["grid"]
    for r in (4, 64):
        pl = slot_mod._tile_plan(r, valid.shape[-1], s, k)
        unions = _tile_unions(positions, valid, s, k, pl.tile)
        assert unions.size == 2 * pl.tiles
        assert unions.max() <= pl.cap, (unions.max(), pl)


def _passes(start, n_c, k0, kn, cap):
    """The kernel's passes over a tile's columns k0 … k0 + kn − 1: as many
    columns at a time as stage within ``cap`` (the bisection of
    csrc/interp.cu), as (first, count) ranges with their unions."""
    out, c_lo = [], 0
    while c_lo < kn:
        base = start[k0 + c_lo]
        c_hi = kn
        if start[k0 + kn - 1] + n_c - base > cap:
            lo, hi = c_lo + 1, kn - 1
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if start[k0 + mid - 1] + n_c - base <= cap:
                    lo = mid
                else:
                    hi = mid - 1
            c_hi = lo
        out.append(((c_lo, c_hi - c_lo), start[k0 + c_hi - 1] + n_c - base))
        c_lo = c_hi
    return out


@pytest.mark.parametrize("r", (4, 64))
def test_slot_tile_passes_fit_and_cover(r):
    """Slots that share a resource element: the first frame's tile holds
    more sorted pilots than its plan stages, and its passes each fit and
    cover its columns once; a tile within its plan takes one pass."""
    c = hard_cases.slot_case("dup_slots")
    positions, valid, (s, k) = c["positions"].numpy(), c["valid"].numpy(), c["grid"]
    pl = slot_mod._tile_plan(r, valid.shape[-1], s, k)
    cand = min(CANDIDATES, valid.shape[-1])
    most = 0
    for pos, ok in zip(positions, valid):
        cols = np.sort(pos[ok > 0, 1])
        start = np.clip(np.searchsorted(cols, np.arange(k), side="left") - cand // 2, 0,
                        max(cols.size - cand, 0))
        for k0, kn in pl.columns(k):
            passes = _passes(start, min(cand, cols.size), k0, kn, pl.cap)
            _covered_once([cols_ for cols_, _ in passes], kn)
            assert all(union <= pl.cap for _, union in passes)
            whole = start[k0 + kn - 1] + min(cand, cols.size) - start[k0]
            assert (len(passes) == 1) == (whole <= pl.cap)
            most = max(most, len(passes))
    assert most >= 2


@functools.lru_cache(maxsize=None)
def _j_grid():
    from ce5g_tpu.estimators.interpolate import interpolate_grid

    return jax.jit(interpolate_grid, static_argnames=("method", "impl"))


@functools.lru_cache(maxsize=None)
def _j_slots():
    from ce5g_tpu.estimators.interpolate import interpolate

    return jax.jit(functools.partial(interpolate, impl="xla"), static_argnums=(3, 4))


@pytest.mark.parametrize("method", ["nearest", "linear"])
@pytest.mark.parametrize("case,r", [("lattice", 9), ("density_25", 16), ("comb", 64),
                                    ("s140", 12), ("nr_carrier", 9)])
def test_grid_envelope_matches_xla(case, r, method):
    """More than 8 antennas, 140 symbols and the NR carrier, against the
    JAX package's XLA branch frame by frame."""
    vals, mask = hard_cases.grid_case(case, r)
    out = grid_mod.interpolate_grid_fused(vals, mask, method).numpy()
    assert out.shape == tuple(vals.shape) and np.all(np.isfinite(out))
    for f in range(vals.shape[0]):
        ref = _j_grid()(jnp.asarray(vals[f].numpy()), jnp.asarray(mask[f].numpy()),
                        method=method, impl="xla")
        np.testing.assert_allclose(out[f], np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("case,r", [("full_column", 9), ("few_valid", 16), ("past_cap", 4),
                                    ("s140", 64), ("dup_slots", 9)])
def test_slot_envelope_matches_xla(case, r, method):
    """More than 8 antennas, P past one block's shared memory on the NR
    carrier, 140 symbols and slots that share a resource element, against
    the JAX package's XLA branch."""
    c = hard_cases.slot_case(case, r)
    vals, pos, valid = (c[key].numpy() for key in ("values", "positions", "valid"))
    out = slot_mod.interpolate_slots(c["values"], c["positions"], c["valid"], c["grid"],
                                     method).numpy()
    assert out.shape == (vals.shape[0], r) + tuple(c["grid"])
    for f in range(vals.shape[0]):
        ref = _j_slots()(vals[f], pos[f], valid[f], c["grid"], method)
        np.testing.assert_allclose(out[f], np.asarray(ref), rtol=0, atol=1e-5)


def _nr_carrier(jcfg):
    """100 MHz NR at 30 kHz (3GPP TS 38.101-1 Table 5.3.2-1, 273 PRB):
    FFT 4096, CP 288, 3276 useful subcarriers (K = 3275 without DC), 3.5 GHz."""
    from ce5g_tpu import MIMOConfig, OFDMConfig

    return dataclasses.replace(
        jcfg,
        ofdm=OFDMConfig(fft_size=4096, cp_length=288, num_symbols=14, useful_subcarriers=3276,
                        subcarrier_spacing=30000.0),
        channel=dataclasses.replace(jcfg.channel, carrier_freq=3.5e9),
        mimo=MIMOConfig(num_tx=4, num_rx=4),
    )


def _lte_frame_etu300(jcfg):
    """One LTE radio frame (10 subframes of 14 symbols) at the default
    numerology, 4×4, ETU at 300 Hz (3GPP TS 36.104 Annex B.2): mmse_full's
    time rank 19, an n = 171 system."""
    from ce5g_tpu import MIMOConfig

    return dataclasses.replace(
        jcfg,
        ofdm=dataclasses.replace(jcfg.ofdm, num_symbols=140),
        channel=dataclasses.replace(jcfg.channel, doppler_hz=(300.0,)),
        mimo=MIMOConfig(num_tx=4, num_rx=4),
    )


#: name → (the JAX config from the default one, frames: profile, Doppler, SNR, density)
CONFIGS = {
    "4x12_599": (lambda c: dataclasses.replace(
        c, mimo=dataclasses.replace(c.mimo, num_tx=4, num_rx=12)),
        ([2, 1], [200.0, 50.0], [10.0, 20.0], [0.10, 0.05])),
    "nr100_4x4": (_nr_carrier, ([2], [200.0], [10.0], [0.10])),
    "lte_frame_etu300_4x4": (_lte_frame_etu300, ([2], [300.0], [10.0], [0.10])),
}
ESTIMATORS = (("ls", "linear"), ("ls", "cubic"), ("mmse_full", "linear"))


@functools.lru_cache(maxsize=None)
def _config_frames(name):
    from ce5g_tpu import ExperimentConfig

    make, params = CONFIGS[name]
    jcfg = make(ExperimentConfig())
    jf, tf = simulate_both(jcfg, jax_params(*params), seed=len(name))
    return jcfg, jf, tf


def _db(h, x):
    return 10 * np.log10(np.mean(np.abs(h - x) ** 2) / np.mean(np.abs(h) ** 2))


def _mmse_full_float64(cfg, frames):
    """The port's mmse_full on ``frames`` in float64 (its per-frame branch)."""
    from ce5g_torch.estimators.time_prior import auto_time_rank
    from ce5g_torch.estimators.mmse import mmse_full_estimate
    from ce5g_torch.physics.simulate import table_for, table_tensors

    amp, f = table_tensors(table_for(cfg), cfg, torch.device("cpu"))
    pidx = frames.params.profile_idx.long()

    def wide(x):
        return x.to(torch.complex128)

    return mmse_full_estimate(
        wide(frames.rx_symbols), wide(frames.tx_symbols[:, :, 0, :]), frames.pilot_mask,
        cfg.mimo.num_tx, frames.params.snr_db, wide(f[pidx]), amp[pidx].double(),
        frames.params.doppler_hz, cfg.ofdm.symbol_duration, time_rank=auto_time_rank(cfg))


@pytest.mark.parametrize("estimator,method", ESTIMATORS)
@pytest.mark.parametrize("config", tuple(CONFIGS))
def test_slice_at_envelope_configs(config, estimator, method):
    """simulate → estimate at the envelope configurations, on the same
    draws in both packages. The JAX package's mmse_full differs from the
    port's by its float32 Woodbury cancellation (≈3e-3 of the rms here):
    it is held to NMSE, the port to its own float64 run."""
    from ce5g_tpu.estimators.api import estimate_batch as j_estimate_batch
    from ce5g_torch.estimators import estimate_batch

    jcfg, jf, tf = _config_frames(config)
    cfg = port_cfg(jcfg)
    ref = np.asarray(jax.jit(functools.partial(
        j_estimate_batch, cfg=jcfg, estimator=estimator, method=method))(jf))
    got = estimate_batch(tf, cfg=cfg, estimator=estimator, method=method, device="cpu").numpy()
    assert got.shape == ref.shape
    h = np.asarray(jf.channel)
    assert abs(_db(h, got) - _db(h, ref)) < 0.01
    if estimator == "mmse_full":
        ref = _mmse_full_float64(cfg, tf).numpy()
    rms = np.sqrt(np.mean(np.abs(ref) ** 2))
    assert np.abs(got - ref).max() <= 1e-5 * rms, np.abs(got - ref).max() / rms


def test_jax_mmse_full_gap_is_its_float32_rounding():
    """On the NR carrier the JAX package's float32 mmse_full is ≈2e-3 of
    the rms from the port's. Its own Woodbury form carried out in float64
    agrees with the port's float64 run to 1e-9: the gap is float32
    rounding in that form (its (e − corr)/σ² cancellation), not a
    difference in what the two packages compute."""
    from _torch_parity import woodbury_mmse_full
    from ce5g_torch.estimators.time_prior import auto_time_rank
    from ce5g_torch.physics.simulate import table_for, table_tensors

    jcfg, jf, tf = _config_frames("nr100_4x4")
    cfg = port_cfg(jcfg)
    amp, f = table_tensors(table_for(cfg), cfg, torch.device("cpu"))
    pidx = tf.params.profile_idx.long()
    wood = woodbury_mmse_full(
        tf.rx_symbols.to(torch.complex128), tf.tx_symbols[:, :, 0, :].to(torch.complex128),
        tf.pilot_mask, cfg.mimo.num_tx, tf.params.snr_db, f[pidx].to(torch.complex128),
        amp[pidx].double(), tf.params.doppler_hz, cfg.ofdm.symbol_duration,
        auto_time_rank(cfg)).numpy()
    port = _mmse_full_float64(cfg, tf).numpy()
    rms = np.sqrt(np.mean(np.abs(port) ** 2))
    assert np.abs(wood - port).max() <= 1e-9 * rms


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", grid_mod.ROUTES)
@pytest.mark.parametrize("case", hard_cases.GRID_CASES)
def test_grid_kernel_envelope_matches_plain(card, case, route):
    for r in (4,) + hard_cases.WIDE_R:
        v, mask = (x.to(card) for x in hard_cases.grid_case(case, r))
        for method in ("nearest", "linear"):
            before = profiling.counters.copy()
            out = grid_mod._launch(grid_mod._plan(r, *mask.shape[1:], route), v, mask, method)
            moved = profiling.counters - before
            assert profiling.launches("interp_fused", moved) == moved[f"ops.interp_fused.{route}"] == 1
            ref = grid_mod.interpolate_grid_plain(v, mask, method)
            assert float((out - ref).abs().max()) <= 1e-5 * float(v.abs().max()), (r, method)


@pytest.mark.cuda
@pytest.mark.parametrize("route", slot_mod.ROUTES)
@pytest.mark.parametrize("case", hard_cases.SLOT_CASES)
def test_slot_kernel_envelope_matches_plain(card, case, route):
    for r in (1, 3, 4) + hard_cases.WIDE_R:
        c = hard_cases.slot_case(case, r)
        v, pos, valid = (c[key].to(card) for key in ("values", "positions", "valid"))
        p = v.shape[-1]
        if route == "frame" and slot_mod._frame_smem(r, p, c["grid"][1]) > MAX_SMEM:
            continue  # the frame does not fit one block: only 'tile' takes it
        pl = slot_mod._plan(r, p, *c["grid"], route)
        for method in ("nearest", "linear", "cubic"):
            before = profiling.counters.copy()
            out = slot_mod._launch(pl, v, pos, valid, c["grid"], method)
            moved = profiling.counters - before
            assert profiling.launches("interp", moved) == moved[f"ops.interp.{route}"] == 1
            ref = slot_mod.interpolate_slots_plain(v, pos, valid, c["grid"], method)
            assert float((out - ref).abs().max()) <= 1e-5 * float(v.abs().max()), (r, method)
            assert bool((out[valid.sum(-1) == 0] == 0).all())


#: the HPD hard cases past the register kernel's R or n
HPD_ENVELOPE_CASES = ("r9", "r16", "r64", "r64_n128", "not_pd_r16", "n129", "n160_r64",
                      "n300_r9", "not_pd_n140", "nan_entry_n150", "last_pivot_n200", "n135_r4",
                      "n171_r4", "n243_r4", "n400_r4")


def _hpd_holds(x, ref, bad):
    """NaN exactly for the systems in ``bad``, the others within 1e-4
    relative of the plain version."""
    x, ref = x.cpu(), ref.cpu()
    is_bad = torch.zeros(x.shape[0], dtype=torch.bool)
    is_bad[list(bad)] = True
    assert bool(torch.isnan(x[is_bad]).all()) and bool(torch.isfinite(x[~is_bad]).all())
    err = float(torch.linalg.norm(x[~is_bad] - ref[~is_bad]) / torch.linalg.norm(ref[~is_bad]))
    assert err < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", HPD_ENVELOPE_CASES)
def test_hpd_kernel_envelope_matches_plain(card, case):
    gram, rhs, bad = hard_cases.hpd_case(case)
    g, h = gram.to(card), rhs.to(card)
    before = profiling.counters.copy()
    x = hpd_mod.hpd_solve(g, h)
    moved = profiling.counters - before
    route = f"ops.hpd_solve.{hpd_mod.plan(*h.shape[1:]).route}"
    assert profiling.launches("hpd_solve", moved) == moved[route] == 1
    _hpd_holds(x, hpd_mod.hpd_solve_plain(g, h), bad)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in hard_cases.HPD_CASES
                                  if hard_cases.HPD_SHAPES[c][1] > hpd_mod.MAX_N])
def test_hpd_kernel_cluster_sizes_match_plain(card, case):
    """Every cluster size with an instance for the case, forced through
    the private ``_launch``."""
    gram, rhs, bad = hard_cases.hpd_case(case)
    g, h = gram.to(card), rhs.to(card)
    ref = hpd_mod.hpd_solve_plain(g, h)
    n, r = rhs.shape[1:]
    for blocks in hpd_mod.CLUSTER_SIZES:
        if hpd_mod._instance(n, r, blocks) is not None:
            _hpd_holds(hpd_mod._launch(hpd_mod._plan(n, r, blocks), g, h), ref, bad)
