"""The scattered-pilot selection (``ce5g_torch.ops.pilot_select``).

On the CPU: the plan's route, cluster, frames a block and grid at the
benchmark's shapes and at the edges of each route; the blocks' words
walked as the kernel walks them (every element of a frame in one word of
one block, whatever its alignment); the wrapper's checks; and the plain
version against the pattern rule as the port ran it before the kernel.
The tests marked ``cuda`` hold the kernel to the plain version on the
same card inputs, bit for bit, and need a card.
"""
import numpy as np
import pytest
import torch

from ce5g_torch.ops import _build
from ce5g_torch.ops import pilot_select as select_mod
from ce5g_torch.physics.pilots import num_pilots_for, scattered_pattern
from ce5g_torch.utils import profiling

SMS = 132  # an H100's SMs
MAX_DENSITY = 0.15
#: (B, S, K) of the benchmark's cells: bench_4x4, nr100_4x64, lte_frame_etu300_4x4
CELLS = {"bench_4x4": (256, 14, 599), "nr100_4x64": (64, 14, 3275),
         "lte_frame_etu300_4x4": (512, 140, 599)}
ONE_BLOCK = 4 * select_mod.MAX_WORDS - 3  # the largest frame one block keeps


def _before(u, num_symbols, num_subcarriers, density, max_density=MAX_DENSITY):
    """``physics.pilots.scattered_pattern`` as the port had it before the
    kernel: the reference of the plain version."""
    b, total = u.shape
    p_max = int(total * max_density)
    dev = u.device
    n_pilots = num_pilots_for(num_symbols, num_subcarriers, density).to(dev)
    n_pilots = n_pilots.expand(b).contiguous()
    lo = torch.zeros(b, dtype=torch.float32, device=dev)
    hi = torch.ones(b, dtype=torch.float32, device=dev)
    for _ in range(25):
        mid = 0.5 * (lo + hi)
        above = (u < mid[:, None]).sum(dim=1) >= n_pilots
        lo, hi = torch.where(above, lo, mid), torch.where(above, mid, hi)
    pre = u < hi[:, None]
    rank = torch.cumsum(pre.to(torch.int32), dim=1) - 1
    sel = pre & (rank < n_pilots[:, None])
    mask = sel.reshape(b, num_symbols, num_subcarriers).to(torch.float32)
    slots = torch.where(sel, rank, p_max).to(torch.int64)
    lin_idx = torch.arange(total, dtype=torch.int32, device=dev).expand(b, total)
    lin = torch.zeros(b, p_max + 1, dtype=torch.int32, device=dev)
    lin = lin.scatter(1, slots, lin_idx)[:, :p_max]
    positions = torch.stack(
        [lin // num_subcarriers, lin % num_subcarriers], dim=-1
    ).to(torch.int32)
    valid = (torch.arange(p_max, device=dev)[None, :] < n_pilots[:, None]).to(torch.float32)
    return mask, positions, valid, n_pilots


def _equal(got, want):
    for name, a, b in zip(("mask", "positions", "valid", "num_pilots"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, int((a != b).sum()))


# ---------------------------------------------------------------- the plan

PLANS = {
    # name: (B, S·K) → (route, cluster, frames a block, words a block, threads, grid)
    "bench_4x4": ((256, 14 * 599), ("block", 1, 1, 2098, 512, 256)),
    "nr100_4x64": ((64, 14 * 3275), ("cluster", 2, 1, 5732, 1024, 128)),
    "lte_frame_etu300_4x4": ((512, 140 * 599), ("cluster", 2, 1, 10483, 1024, 1024)),
    "nr_frame_hst500_4x4": ((128, 280 * 611), ("cluster", 4, 1, 10693, 1024, 512)),
    "one frame": ((1, 14 * 599), ("cluster", 2, 1, 1049, 256, 2)),
    "one frame, nr100": ((1, 14 * 3275), ("cluster", 8, 1, 1433, 256, 8)),
    "one element": ((1, 1), ("block", 1, 1, 1, 32, 1)),
    "odd size, many frames": ((4096, 6 * 39), ("block", 1, 3, 60, 32, 1366)),
    "the largest one block keeps": ((256, ONE_BLOCK), ("block", 1, 1, 14336, 1024, 256)),
    "one more": ((256, ONE_BLOCK + 1), ("cluster", 2, 1, 7169, 1024, 512)),
    "the largest a cluster keeps": ((2, select_mod.MAX_RESIDENT),
                                    ("cluster", 8, 1, 14336, 1024, 16)),
    "one more, read again each round": ((2, select_mod.MAX_RESIDENT + 1),
                                        ("global", 8, 1, 14337, 1024, 16)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan(name):
    (b, total), want = PLANS[name]
    pl = select_mod.plan_for(b, total, SMS)
    assert (pl.route, pl.cluster, pl.frames, pl.words, pl.threads, pl.grid) == want
    assert pl.route == "global" or 16 * pl.words <= 227 * 1024 - 1024  # a block's shared memory
    assert pl.cluster * pl.words >= select_mod.frame_words(total)
    assert pl.grid * pl.frames >= b if pl.cluster == 1 else pl.grid == b * pl.cluster


def test_plan_rejects_an_empty_frame():
    with pytest.raises(ValueError, match="no plan"):
        select_mod.plan_for(4, 0, SMS)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_blocks_hold_every_element_once(name):
    """The words of each block, as the kernel cuts a frame that starts
    0-3 elements past a 16-byte boundary: every element of the frame in
    one word of one block, each block within its ``words``."""
    (_, total), _ = PLANS[name]
    if total > 100_000:
        total = 4 * 1000 + 3  # the same arithmetic; keep the check small
    pl = select_mod.plan_for(1, total, SMS)
    for phase in range(4):
        words = (total + phase + 3) >> 2
        assert words <= select_mod.frame_words(total) <= pl.cluster * pl.words
        seen = np.zeros(total, np.int64)
        for q in range(pl.cluster):
            s0, s1 = min(q * pl.words, words), min((q + 1) * pl.words, words)
            assert s1 - s0 <= pl.words
            e = 4 * np.arange(s0, s1)[:, None] - phase + np.arange(4)
            e = e[(e >= 0) & (e < total)]
            np.add.at(seen, e, 1)
        assert (seen == 1).all(), phase


def test_work():
    b, s, k = CELLS["lte_frame_etu300_4x4"]
    p_max = int(s * k * MAX_DENSITY)
    nbytes, flops = select_mod.work(b, s * k, p_max)
    assert p_max == 12579
    assert nbytes == 8 * b * s * k + 12 * b * p_max + 4 * b
    assert abs(nbytes / 3.35e12 * 1e3 - 0.126) < 0.001  # ms at 3.35 TB/s
    assert flops == 26 * b * s * k


# ---------------------------------------------------------------- the wrapper


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    u = torch.rand(2, 6 * 39)
    n = torch.tensor([23, 5], dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        select_mod.pilot_select(u.double(), n, 6, 39, 35)
    with pytest.raises(TypeError, match="gradient"):
        select_mod.pilot_select(u.clone().requires_grad_(), n, 6, 39, 35)
    with pytest.raises(ValueError, match="n_pilots on meta"):
        select_mod.pilot_select(u, n.to("meta"), 6, 39, 35)
    with pytest.raises(ValueError, match="uniforms"):
        select_mod.pilot_select(u, n, 6, 40, 35)
    with pytest.raises(ValueError, match="int32"):
        select_mod.pilot_select(u, n.long(), 6, 39, 35)
    with torch.no_grad():  # no gradient is recorded: the kernel may take it
        select_mod.pilot_select(u.clone().requires_grad_(), n, 6, 39, 35)


def _uniforms(seed, b, total, kind="uniform"):
    """(B, S·K) float32 in [0, 1): uniform, repeated (64 values), all one
    value, on bisection midpoints k/2^j, or below 2^-25."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        u = rng.random((b, total), dtype=np.float32)
    elif kind == "repeated":
        u = (rng.integers(0, 64, (b, total)) / 64).astype(np.float32)
    elif kind == "equal":
        u = np.full((b, total), 0.3, np.float32)
    elif kind == "midpoints":
        j = rng.integers(1, 26, (b, total))
        u = (rng.integers(0, 2 ** 25, (b, total)) % (2 ** j) / 2.0 ** j).astype(np.float32)
    elif kind == "tiny":
        u = (rng.random((b, total)) * 2.0 ** -26).astype(np.float32)
        u[:, ::7] = 0.0
    else:
        raise ValueError(kind)
    return torch.from_numpy(u)


KINDS = ("uniform", "repeated", "equal", "midpoints", "tiny")
DENSITIES = torch.tensor([0.0, 0.01, 0.1, MAX_DENSITY])


@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_is_the_rule_before_the_kernel(kind):
    s, k = 14, 599
    u = _uniforms(3, 4, s * k, kind)
    before = profiling.counters.copy()
    got = scattered_pattern(u, s, k, DENSITIES, MAX_DENSITY)
    assert profiling.counters - before == {"ops.pilot_select.plain": 1}
    _equal(got, _before(u, s, k, DENSITIES))
    assert got.mask.sum(dim=(1, 2)).tolist() == got.num_pilots.tolist()


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _build.library("pilot_select")  # built and loaded before any test counts launches
    return torch.device("cuda")


def _on_card(card, u, s, k, density, max_density=MAX_DENSITY, plan=None):
    """The kernel's pattern (by its own plan, or by ``plan``) and the plain
    version's, on the same card inputs."""
    u = u.to(card)
    b, total = u.shape
    p_max = int(total * max_density)
    n = num_pilots_for(s, k, density).to(card).expand(b).contiguous()
    if plan is None:
        got = scattered_pattern(u, s, k, density, max_density)
    else:
        got = (*select_mod._launch(plan, u, n, s, k, p_max), n)
    want = (*select_mod.pilot_select_plain(u, n, s, k, p_max), n)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_kernel_at_the_cells(card, cell):
    b, s, k = CELLS[cell]
    gen = torch.Generator(device=card).manual_seed(20)
    u = torch.rand(b, s * k, generator=gen, device=card)
    before = profiling.counters.copy()
    got, want = _on_card(card, u, s, k, 0.1)
    pl = select_mod.plan(u)
    assert profiling.counters - before == {f"ops.pilot_select.{pl.route}": 1}
    _equal(got, want)
    assert int(got.mask.sum()) == b * int(num_pilots_for(s, k, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 14, 599), (4, 140, 599), (1, 14, 599), (1, 14, 3275)])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_per_frame_densities_and_hard_values(card, shape, kind):
    b, s, k = shape
    density = DENSITIES[:b] if b == 4 else DENSITIES[2:3]
    _equal(*_on_card(card, _uniforms(5, b, s * k, kind), s, k, density))


@pytest.mark.cuda
def test_kernel_many_small_frames_unaligned(card):
    """Frames of 6 × 39 (not a multiple of 4), several a block, from
    uniforms that start one element past a 16-byte boundary: every frame
    starts at another offset and the mask is written element by element."""
    b, s, k = 4096, 6, 39
    assert select_mod.plan_for(b, s * k, SMS).frames > 1
    store = torch.rand(b * s * k + 1, device=card)
    u = store[1:].view(b, s * k)
    assert u.is_contiguous() and u.data_ptr() % 16 == 4
    density = DENSITIES.repeat(b // 4).to(card)
    _equal(*_on_card(card, u, s, k, density))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", select_mod.CLUSTER_SIZES)
@pytest.mark.parametrize("resident", [True, False])
def test_kernel_by_every_cluster_and_both_memories(card, cluster, resident):
    """One input by each cluster size, its words kept on chip or read
    again from memory each round (the 'global' route's instance)."""
    b, s, k = 3, 14, 599
    words = -(-select_mod.frame_words(s * k) // cluster)
    pl = select_mod.Plan("cluster" if resident else "global", cluster, 1, words, 256,
                         b * cluster)
    if resident and cluster == 1:
        pl = select_mod.Plan("block", 1, 2, words, 256, 2)
    for kind in ("uniform", "repeated", "midpoints"):
        _equal(*_on_card(card, _uniforms(9, b, s * k, kind), s, k, DENSITIES[1:], plan=pl))


@pytest.mark.cuda
def test_kernel_global_route(card):
    """A frame past what a cluster of 8 keeps: read again each round."""
    b, s = 2, 2
    k = (select_mod.MAX_RESIDENT + 1) // 2 + 1
    u = _uniforms(11, b, s * k, "repeated").to(card)
    assert select_mod.plan(u).route == "global"
    before = profiling.counters.copy()
    got, want = _on_card(card, u, s, k, 0.1)
    assert profiling.counters - before == {"ops.pilot_select.global": 1}
    _equal(got, want)
