"""Port parity: ce5g_torch's kernel modules against ce5g_tpu's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that version against the JAX kernel itself (Pallas interpret
mode) and against the JAX package's XLA path, on the same numpy inputs.
The tests marked ``cuda`` hold the CUDA kernels against the plain
versions and run only where there is a card (``chip_smoke.py`` does the
same on the main path's shapes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ce5g_torch.ops import hpd_solve as hpd_mod
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


def test_cpu_tensors_take_the_plain_version():
    before = (hpd_mod.launches, interp_mod.launches)
    gram, rhs = _hpd_problem(5, 2, 6, 2)
    hpd_mod.hpd_solve(torch.from_numpy(gram), torch.from_numpy(rhs))
    interp_mod.interpolate_grid_fused(
        torch.zeros(1, 2, 6, 39, dtype=torch.complex64), torch.zeros(1, 6, 39), "linear"
    )
    assert (hpd_mod.launches, interp_mod.launches) == before


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
    with pytest.raises(NotImplementedError, match="later slice"):
        interpolate_grid(v, mask, "cubic")
    with pytest.raises(NotImplementedError, match="later slice"):
        interpolate_grid(v, None, "linear")


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
@pytest.mark.parametrize("method", ["nearest", "linear"])
def test_interp_kernel_matches_plain(card, method):
    vals, mask = _interp_inputs(8, 4, 14, 599)
    v, m = torch.from_numpy(vals).to(card), torch.from_numpy(mask).to(card)
    out = interp_mod.interpolate_grid_fused(v, m, method)
    ref = interp_mod.interpolate_grid_plain(v, m, method)
    assert float((out - ref).abs().max()) <= 1e-5
