"""Port parity: ce5g_torch's kernel modules against ce5g_tpu's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that version against the JAX kernel itself (Pallas interpret
mode) and against the JAX package's XLA path, on the same numpy inputs.
The tests marked ``cuda`` hold the CUDA kernels against the plain
versions and run only where there is a card (``chip_smoke.py`` does the
same on the main path's shapes).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ce5g_torch.ops import hard_cases
from ce5g_torch.ops import hpd_solve as hpd_mod
from ce5g_torch.ops import interp as slot_mod
from ce5g_torch.ops import interp_fused as interp_mod


def _hpd_problem(seed, b, n, r, cond=100.0):
    """Random HPD systems as in tests/test_hpd_solve.py, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, n)) + 1j * rng.standard_normal((b, n, n))
    gram = np.einsum("bij,bkj->bik", x, np.conj(x)) + (n / cond) * np.eye(n)
    rhs = rng.standard_normal((b, n, r)) + 1j * rng.standard_normal((b, n, r))
    return gram.astype(np.complex64), rhs.astype(np.complex64)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("b,n,r", [(128, 45, 4), (37, 12, 3)])
def test_hpd_solve_matches_jax(b, n, r):
    """(128, 45, 4) is the mmse_full shape; 37 systems need padding in JAX."""
    from ce5g_tpu.ops.hpd_solve_pallas import _xla_solve, hpd_solve as j_hpd_solve

    gram, rhs = _hpd_problem(b * n, b, n, r)
    x = hpd_mod.hpd_solve(torch.from_numpy(gram), torch.from_numpy(rhs)).numpy()
    x_kernel = np.asarray(j_hpd_solve(jnp.asarray(gram), jnp.asarray(rhs), force="interpret"))
    x_xla = np.asarray(_xla_solve(jnp.asarray(gram), jnp.asarray(rhs)))
    assert x.shape == (b, n, r)
    assert _rel(x, x_kernel) < 1e-4  # the bound of tests/test_hpd_solve.py
    assert _rel(x, x_xla) < 1e-4


def test_hpd_solve_residual_and_nan():
    gram, rhs = _hpd_problem(2, 16, 24, 4, cond=1e4)
    x = hpd_mod.hpd_solve(torch.from_numpy(gram), torch.from_numpy(rhs)).numpy()
    resid = np.linalg.norm(np.einsum("bij,bjk->bik", gram, x) - rhs) / np.linalg.norm(rhs)
    assert resid < 1e-3
    # a system that is not positive definite comes back NaN, the rest finite
    gram[3] = -np.eye(24, dtype=np.complex64)
    x = hpd_mod.hpd_solve(torch.from_numpy(gram), torch.from_numpy(rhs)).numpy()
    assert np.all(np.isnan(x[3]))
    assert np.all(np.isfinite(np.delete(x, 3, axis=0)))


@pytest.mark.parametrize("case", hard_cases.HPD_CASES)
def test_hpd_solve_hard_cases_match_jax(case):
    """The inputs that stress the CUDA kernel's design (n at the edges of
    its thread grid's blocks, R = 1-8, one system, cond 1e4, systems that
    are not positive definite), through the JAX package's XLA solve and,
    for n within its limit, the Pallas kernel in interpret mode."""
    from ce5g_tpu.ops.hpd_solve_pallas import MAX_N, _xla_solve, hpd_solve as j_hpd_solve

    gram, rhs, bad = hard_cases.hpd_case(case)
    x = hpd_mod.hpd_solve(gram, rhs).numpy()
    refs = [np.asarray(_xla_solve(jnp.asarray(gram.numpy()), jnp.asarray(rhs.numpy())))]
    if gram.shape[1] <= MAX_N:
        refs.append(np.asarray(j_hpd_solve(jnp.asarray(gram.numpy()), jnp.asarray(rhs.numpy()),
                                           force="interpret")))
    is_bad = np.zeros(gram.shape[0], bool)
    is_bad[list(bad)] = True
    assert x.shape == tuple(rhs.shape)
    assert np.all(np.isnan(x[is_bad])) and np.all(np.isfinite(x[~is_bad]))
    for ref in refs:
        assert np.all(np.isnan(ref[is_bad])) and np.all(np.isfinite(ref[~is_bad]))
        assert _rel(x[~is_bad], ref[~is_bad]) < 1e-4


def test_hpd_limits_and_work():
    """The wrapper's shape rules hold before any launch."""
    assert (hpd_mod.MAX_N, hpd_mod.MAX_R) == (128, 8)
    gram, rhs, _ = hard_cases.hpd_case("n9")
    with pytest.raises(ValueError, match="expected gram"):
        hpd_mod.hpd_solve(gram, rhs[:, :-1])
    assert hpd_mod.work(256, 45, 4) == (8 * 256 * (45 * 45 + 2 * 45 * 4),
                                        8 * 256 * (45 ** 3 / 6 + 45 * 45 * 4))


def test_cpu_tensors_take_the_plain_version():
    before = (hpd_mod.launches, interp_mod.launches, slot_mod.launches)
    gram, rhs = _hpd_problem(5, 2, 6, 2)
    hpd_mod.hpd_solve(torch.from_numpy(gram), torch.from_numpy(rhs))
    interp_mod.interpolate_grid_fused(
        torch.zeros(1, 2, 6, 39, dtype=torch.complex64), torch.zeros(1, 6, 39), "linear"
    )
    slot_mod.interpolate_slots(
        torch.zeros(1, 2, 23, dtype=torch.complex64), torch.zeros(1, 23, 2, dtype=torch.int32),
        torch.zeros(1, 23), (6, 39), "cubic",
    )
    assert (hpd_mod.launches, interp_mod.launches, slot_mod.launches) == before


def _interp_inputs(b, r, s, k, density=0.10, seed=0):
    """Masked complex values and scattered-pilot masks from ce5g_tpu."""
    from ce5g_tpu.physics.pilots import make_pattern

    keys = jax.random.split(jax.random.key(seed), b)
    mask = np.asarray(jax.vmap(lambda key: make_pattern(key, s, k, density).mask)(keys))
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, r, s, k)) + 1j * rng.standard_normal((b, r, s, k))
    return (v * mask[:, None]).astype(np.complex64), np.array(mask)


@pytest.mark.parametrize("method", ["nearest", "linear"])
@pytest.mark.parametrize(
    "frames,shape,density",
    [(2, (2, 6, 39), 0.10), (1, (4, 14, 599), 0.10), (1, (2, 14, 599), 0.01)],
)
def test_interpolate_grid_matches_jax(frames, shape, density, method):
    """Against the Pallas kernel in interpret mode and the XLA branch; at
    1% density some rows hold no pilot."""
    from ce5g_tpu.estimators.interpolate import interpolate_grid as j_interpolate_grid
    from ce5g_tpu.ops.interp_fused_pallas import interpolate_grid_fused as j_fused
    from ce5g_torch.estimators.interpolate import interpolate_grid

    j_xla = jax.jit(j_interpolate_grid, static_argnames=("method", "impl"))
    r, s, k = shape
    vals, mask = _interp_inputs(frames, r, s, k, density)
    out = interpolate_grid(torch.from_numpy(vals), torch.from_numpy(mask), method).numpy()
    for f in range(frames):
        v, m = jnp.asarray(vals[f]), jnp.asarray(mask[f])
        ref_kernel = np.asarray(j_fused(v, m, method, interpret=True))
        ref_xla = np.asarray(j_xla(v, m, method=method, impl="xla"))
        np.testing.assert_allclose(out[f], ref_kernel, rtol=0, atol=1e-5)
        np.testing.assert_allclose(out[f], ref_xla, rtol=0, atol=1e-5)
    # one frame without the batch axis gives the same grid
    one = interpolate_grid(torch.from_numpy(vals[0]), torch.from_numpy(mask[0]), method)
    np.testing.assert_array_equal(one.numpy(), out[0])


def test_interpolate_grid_empty_mask_and_rules():
    from ce5g_torch.estimators.interpolate import interpolate_grid

    mask = torch.zeros(2, 14, 599)
    v = torch.zeros(2, 3, 14, 599, dtype=torch.complex64)
    for method in ("nearest", "linear"):
        assert torch.all(interpolate_grid(v, mask, method) == 0)
    # as in ce5g_tpu, the grid form takes nearest/linear with a mask only;
    # cubic and mask-free calls take the slot form (interpolate)
    with pytest.raises(ValueError, match="nearest/linear"):
        interpolate_grid(v, mask, "cubic")
    with pytest.raises(ValueError, match="pilot mask"):
        interpolate_grid(v, None, "linear")


@pytest.mark.parametrize("method", ["nearest", "linear"])
@pytest.mark.parametrize("case", hard_cases.GRID_CASES)
def test_interpolate_grid_hard_cases_match_xla(case, method):
    """The inputs that stress the CUDA kernel's design (row pruning, the
    list of accepted candidates, tiles on mask bits), through the JAX
    package's XLA branch and the plain version."""
    from ce5g_tpu.estimators.interpolate import interpolate_grid as j_interpolate_grid

    j_xla = jax.jit(j_interpolate_grid, static_argnames=("method", "impl"))
    vals, mask = hard_cases.grid_case(case)
    out = interp_mod.interpolate_grid_fused(vals, mask, method).numpy()
    assert out.shape == tuple(vals.shape) and np.all(np.isfinite(out))
    for f in range(vals.shape[0]):
        ref = j_xla(jnp.asarray(vals[f].numpy()), jnp.asarray(mask[f].numpy()),
                    method=method, impl="xla")
        np.testing.assert_allclose(out[f], np.asarray(ref), rtol=0, atol=1e-5)


def _slot_inputs(frames, r, s, k, density, max_density=0.25, seed=0):
    """Pilot slots of ce5g_tpu's scattered patterns (one per frame) and
    random complex values, zero at invalid slots, as numpy arrays."""
    from ce5g_tpu.physics import make_pattern

    keys = jax.random.split(jax.random.key(seed + int(density * 997)), frames)
    pats = [make_pattern(key, s, k, density, "scattered", max_density=max_density)
            for key in keys]
    pos = np.stack([np.asarray(p.positions) for p in pats])
    valid = np.stack([np.asarray(p.valid) for p in pats])
    rng = np.random.default_rng(seed)
    shape = (frames, r, pos.shape[1])
    vals = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * valid[:, None]
    return vals.astype(np.complex64), pos, valid


def _slot_interp(vals, pos, valid, grid, method):
    from ce5g_torch.estimators.interpolate import interpolate

    return interpolate(torch.from_numpy(vals), torch.from_numpy(pos),
                       torch.from_numpy(valid), grid, method).numpy()


_j_slot_xla = jax.jit(
    lambda v, p, ok, grid, method: __import__(
        "ce5g_tpu.estimators.interpolate", fromlist=["interpolate"]
    ).interpolate(v, p, ok, grid, method, impl="xla"),
    static_argnums=(3, 4),
)


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("density", [0.02, 0.10, 0.15, 0.20])
def test_interpolate_slots_matches_xla(density, method):
    """The plain version against the JAX package's exact definition, the
    XLA branch of interpolate (128 sorted candidates per column), two
    frames with their own pilots, up to the 20% cell of the parity study."""
    s, k = 14, 599
    vals, pos, valid = _slot_inputs(2, 2, s, k, density)
    out = _slot_interp(vals, pos, valid, (s, k), method)
    assert out.shape == (2, 2, s, k) and out.dtype == np.complex64
    for f in range(2):
        ref = np.asarray(_j_slot_xla(vals[f], pos[f], valid[f], (s, k), method))
        np.testing.assert_allclose(out[f], ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("density", [0.02, 0.10, 0.15])
def test_interpolate_slots_matches_pallas(density, method):
    """Against the TPU kernel itself (interpret mode) under its own
    contract (tests/test_interp_pallas.py): its 384-pilot tile window is
    exact only up to ≈15% density."""
    from ce5g_tpu.ops.interp_pallas import interpolate_pallas

    s, k = 14, 599
    vals, pos, valid = _slot_inputs(1, 2, s, k, density, max_density=0.15)
    got = _slot_interp(vals, pos, valid, (s, k), method)[0]
    want = np.asarray(interpolate_pallas(vals[0], pos[0], valid[0], (s, k), method,
                                         interpret=True))
    if method == "cubic":
        err = np.mean(np.abs(got - want) ** 2) / np.mean(np.abs(want) ** 2)
        assert err < 0.02, err
    else:
        diff = np.abs(got - want)
        assert np.mean(diff < 1e-3) > 0.99
        assert np.mean(diff**2) / np.mean(np.abs(want) ** 2) < 1e-3


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
def test_interpolate_slots_small_grid_and_empty_frame(method):
    """A (6, 100) grid with one rx antenna and fewer than 128 slots
    matches the XLA branch and the Pallas kernel; a frame with no valid
    slot gives zeros; one frame without the batch axis gives the same grid."""
    from ce5g_tpu.ops.interp_pallas import interpolate_pallas

    s, k = 6, 100
    vals, pos, valid = _slot_inputs(2, 1, s, k, 0.10, max_density=0.15, seed=5)
    assert pos.shape[1] < 128
    valid[1] = 0.0
    vals[1] = 0.0
    out = _slot_interp(vals, pos, valid, (s, k), method)
    ref = np.asarray(_j_slot_xla(vals[0], pos[0], valid[0], (s, k), method))
    np.testing.assert_allclose(out[0], ref, rtol=0, atol=1e-5)
    kern = np.asarray(interpolate_pallas(vals[0], pos[0], valid[0], (s, k), method,
                                         interpret=True))
    assert np.mean(np.abs(out[0] - kern) < 1e-3) > 0.99
    assert np.all(out[1] == 0)
    one = _slot_interp(vals[0], pos[0], valid[0], (s, k), method)
    np.testing.assert_allclose(one, out[0], rtol=0, atol=1e-6)  # summation order


@functools.lru_cache(maxsize=None)
def _slot_hard_case_xla(case, method):
    """The XLA branch on a hard case with four antennas, frame by frame."""
    c = hard_cases.slot_case(case, 4)
    vals, pos, valid = (c[key].numpy() for key in ("values", "positions", "valid"))
    return np.stack([np.asarray(_j_slot_xla(vals[f], pos[f], valid[f], c["grid"], method))
                     for f in range(vals.shape[0])])


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize(
    "case,r",
    [("full_column", 1), ("full_column", 2), ("full_column", 3), ("full_column", 4),
     ("few_valid", 2), ("few_slots", 2)],
)
def test_interpolate_slots_hard_cases_match_xla(case, r, method):
    """A column holding every symbol's pilot (ties in the stable sort),
    fewer valid slots than the 128-candidate window (one frame has none)
    and fewer slots than 128, with 1-4 antennas: the antennas of a case
    are the first r of one draw, so one XLA result serves them all."""
    c = hard_cases.slot_case(case, r)
    out = slot_mod.interpolate_slots(c["values"], c["positions"], c["valid"], c["grid"],
                                     method).numpy()
    ref = _slot_hard_case_xla(case, method)[:, :r]
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    empty = c["valid"].sum(-1) == 0
    assert np.all(out[empty.numpy()] == 0)


def test_interpolate_slots_rules_and_work():
    b, r, p, s, k = 2, 3, 50, 6, 39
    vals, pos, valid = _slot_inputs(b, r, s, k, 0.10)
    v, po, ok = torch.from_numpy(vals), torch.from_numpy(pos), torch.from_numpy(valid)
    with pytest.raises(ValueError, match="Unknown interpolation method"):
        slot_mod.interpolate_slots(v, po, ok, (s, k), "spline")
    with pytest.raises(ValueError, match="do not match"):
        slot_mod.interpolate_slots(v, po[:, :-1], ok, (s, k), "linear")
    # cubic scores every valid window entry: (9 + 4R) operations each
    p = pos.shape[1]
    n_valid = valid.sum(-1).astype(int)
    nbytes, flops = slot_mod.work(v, po, ok, (s, k), "cubic")
    assert nbytes == 8 * b * r * p + 12 * b * p + 8 * b * r * s * k
    assert flops == (9 + 4 * r) * s * k * int(np.minimum(n_valid, min(128, p)).sum())
    _, flops_nearest = slot_mod.work(v, po, ok, (s, k), "nearest")
    _, flops_linear = slot_mod.work(v, po, ok, (s, k), "linear")
    assert 0 < flops_nearest < flops_linear


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,r", [(256, 45, 4), (37, 12, 3), (16, 126, 4)])
def test_hpd_kernel_matches_plain(card, b, n, r):
    gram, rhs = _hpd_problem(b + n, b, n, r)
    g, h = torch.from_numpy(gram).to(card), torch.from_numpy(rhs).to(card)
    x = hpd_mod.hpd_solve(g, h)
    ref = hpd_mod.hpd_solve_plain(g, h)
    assert _rel(x.cpu(), ref.cpu()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", hard_cases.HPD_CASES)
def test_hpd_kernel_hard_cases_match_plain(card, case):
    gram, rhs, bad = hard_cases.hpd_case(case)
    g, h = gram.to(card), rhs.to(card)
    before = hpd_mod.launches
    x = hpd_mod.hpd_solve(g, h)
    assert hpd_mod.launches == before + 1
    ref = hpd_mod.hpd_solve_plain(g, h)
    is_bad = torch.zeros(gram.shape[0], dtype=torch.bool)
    is_bad[list(bad)] = True
    x, ref = x.cpu(), ref.cpu()
    assert bool(torch.isnan(x[is_bad]).all()) and bool(torch.isfinite(x[~is_bad]).all())
    assert bool(torch.isnan(ref[is_bad]).all())
    assert _rel(x[~is_bad], ref[~is_bad]) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
def test_hpd_kernel_widest_instances_match_plain(card, b):
    """Every n of the two widest instances (97-128) with every R, at the
    hard cases' scaling (entries of order n, not of order 1)."""
    worst = 0.0
    for n in range(97, 129):
        for r in range(1, 9):
            rng = np.random.default_rng(10 * n + r + 7 * b)
            x = rng.standard_normal((b, n, n)) + 1j * rng.standard_normal((b, n, n))
            gram = x @ np.conj(np.swapaxes(x, 1, 2)) + (n / 100.0) * np.eye(n)
            gram = np.ascontiguousarray(0.5 * (gram + np.conj(np.swapaxes(gram, 1, 2))),
                                        np.complex64)
            rhs = (rng.standard_normal((b, n, r)) + 1j * rng.standard_normal((b, n, r)))
            g, h = torch.from_numpy(gram).to(card), torch.from_numpy(rhs.astype(np.complex64)).to(card)
            err = _rel(hpd_mod.hpd_solve(g, h).cpu(), hpd_mod.hpd_solve_plain(g, h).cpu())
            assert err < 1e-4, (n, r, err)
            worst = max(worst, err)
    print(f"worst relative error {worst:.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["nearest", "linear"])
def test_interp_kernel_matches_plain(card, method):
    vals, mask = _interp_inputs(8, 4, 14, 599)
    v, m = torch.from_numpy(vals).to(card), torch.from_numpy(mask).to(card)
    out = interp_mod.interpolate_grid_fused(v, m, method)
    ref = interp_mod.interpolate_grid_plain(v, m, method)
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("density", [0.01, 0.10, 0.20])
@pytest.mark.parametrize("r", [2, 3, 4])  # 3 takes the body with R at run time
def test_slot_interp_kernel_matches_plain(card, r, density, method):
    vals, pos, valid = _slot_inputs(8, r, 14, 599, density)
    valid[3] = 0.0  # a frame with no valid slot
    v, po, ok = (torch.from_numpy(x).to(card) for x in (vals, pos, valid))
    before = slot_mod.launches
    out = slot_mod.interpolate_slots(v, po, ok, (14, 599), method)
    assert slot_mod.launches == before + 1
    ref = slot_mod.interpolate_slots_plain(v, po, ok, (14, 599), method)
    assert float((out - ref).abs().max()) <= 1e-5 * float(v.abs().max())
    assert bool((out[3] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["nearest", "linear"])
@pytest.mark.parametrize("r", [4, 3])  # 3 takes the body with R at run time
@pytest.mark.parametrize("case", hard_cases.GRID_CASES)
def test_interp_kernel_hard_cases_match_plain(card, case, r, method):
    vals, mask = (x.to(card) for x in hard_cases.grid_case(case, r))
    before = interp_mod.launches
    out = interp_mod.interpolate_grid_fused(vals, mask, method)
    assert interp_mod.launches == before + 1
    ref = interp_mod.interpolate_grid_plain(vals, mask, method)
    assert float((out - ref).abs().max()) <= 1e-5 * float(vals.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("case", hard_cases.SLOT_CASES)
def test_slot_interp_kernel_hard_cases_match_plain(card, case, r, method):
    c = hard_cases.slot_case(case, r)
    v, po, ok = (c[key].to(card) for key in ("values", "positions", "valid"))
    out = slot_mod.interpolate_slots(v, po, ok, c["grid"], method)
    ref = slot_mod.interpolate_slots_plain(v, po, ok, c["grid"], method)
    assert float((out - ref).abs().max()) <= 1e-5 * float(v.abs().max())
    assert bool((out[ok.sum(-1) == 0] == 0).all())
