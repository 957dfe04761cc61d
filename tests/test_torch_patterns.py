"""Port parity of comb and block pilots, pilot insertion and extraction,
normalised-convolution interpolation and the small API helpers
(complexify, host, sanitize, profiling), ce5g_torch against ce5g_tpu on
the same inputs on the CPU.

Tolerances:
  * patterns (mask, positions, valid, count) equal exactly;
  * LS and diagonal MMSE on comb and block frames within 1e-4 of the
    channel's rms (the serving slice's bound); mmse_full within 1e-3 at
    5 dB SNR. Regular pilots condition the Woodbury system of mmse_full
    worse than scattered ones: its condition number grows with SNR and
    pilot count (≈1.3e3 at 5 dB and 15% pilots, 2e4-4e4 at 20 dB), and at
    20 dB either package lies 4e-3 to 1e-2 of the rms from a float64 solve
    of the same frames, so parity is held where float32 allows 1e-3;
  * normalised convolution within 1e-5 of the values' scale.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_params, port_cfg, simulate_both

DENSITIES = (0.01, 0.10, 0.15)


def _jax_pattern(pattern, density):
    from ce5g_tpu.physics import make_pattern

    return make_pattern(jax.random.key(0), 14, 599, density, pattern)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("pattern", ["comb", "block"])
def test_regular_patterns_match_jax(pattern, density):
    from ce5g_torch.physics import make_pattern

    got = make_pattern(torch.rand(2, 14 * 599), 14, 599, torch.tensor([density, 0.05]), pattern)
    for name, want in _jax_pattern(pattern, density)._asdict().items():
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(), np.asarray(want),
                                      err_msg=name)
    # every frame of a batch takes its own density; the draws are ignored
    again = make_pattern(torch.zeros(1, 14 * 599), 14, 599, 0.05, pattern)
    for a, b in zip(got, again):
        assert torch.equal(a[1], b[0])
    assert int(got.num_pilots[0]) == int(got.mask[0].sum()) == int(got.valid[0].sum())


def test_make_pattern_rules():
    from ce5g_torch.physics import make_pattern

    with pytest.raises(ValueError, match="Unknown pilot pattern"):
        make_pattern(torch.zeros(1, 14), 2, 7, 0.1, "diagonal")
    with pytest.raises(ValueError, match="exceeds max_density"):
        make_pattern(torch.zeros(1, 14), 2, 7, 0.2, "comb")


def test_insert_and_extract_pilots_match_jax():
    from ce5g_tpu.physics import extract_pilots as j_extract, insert_pilots as j_insert
    from ce5g_torch.physics import extract_pilots, insert_pilots, make_pattern

    rng = np.random.default_rng(0)
    data = (rng.standard_normal((2, 14, 599)) + 1j * rng.standard_normal((2, 14, 599)))
    pilots = np.exp(1j * rng.uniform(0, 2 * np.pi, (2, 14, 599)))
    data, pilots = data.astype(np.complex64), pilots.astype(np.complex64)
    grid3 = (rng.standard_normal((2, 3, 14, 599))).astype(np.complex64)
    for pattern in ("scattered", "comb", "block"):
        u = rng.random((2, 14 * 599)).astype(np.float32)
        pat = make_pattern(torch.from_numpy(u), 14, 599, torch.tensor([0.02, 0.12]), pattern)
        grid = insert_pilots(pat, torch.from_numpy(data), torch.from_numpy(pilots))
        vals = extract_pilots(pat, torch.from_numpy(grid3))
        assert vals.shape == (2, 3, pat.valid.shape[1])
        for f in range(2):
            jpat = type(_jax_pattern("comb", 0.1))(*(jnp.asarray(x[f].numpy()) for x in pat))
            np.testing.assert_array_equal(grid[f].numpy(),
                                          np.asarray(j_insert(jpat, data[f], pilots[f])))
            np.testing.assert_array_equal(vals[f].numpy(), np.asarray(j_extract(jpat, grid3[f])))


@pytest.fixture(scope="module")
def pattern_frames():
    """Two 2×2 EVA frames a pattern at 5 dB (1% and 15% pilots; 50 and
    200 Hz), simulated by both packages."""
    from ce5g_tpu import ExperimentConfig, MIMOConfig
    from ce5g_tpu.config import PilotConfig

    out = {}
    for pattern in ("comb", "block"):
        jcfg = ExperimentConfig(mimo=MIMOConfig(num_tx=2, num_rx=2),
                                pilots=PilotConfig(pattern=pattern))
        params = jax_params([1, 1], [50.0, 200.0], [5.0, 5.0], [0.01, 0.15])
        out[pattern] = (jcfg,) + simulate_both(jcfg, params, seed=1)
    return out


@pytest.mark.parametrize("estimator,method,tol", [
    ("ls", "linear", 1e-4), ("mmse", "linear", 1e-4), ("mmse_full", "linear", 1e-3),
    ("ls", "cubic", 1e-4),
])
@pytest.mark.parametrize("pattern", ["comb", "block"])
def test_estimates_on_regular_pilots_match_jax(pattern_frames, monkeypatch, pattern, estimator,
                                               method, tol):
    import ce5g_torch.estimators.mmse as mmse_mod
    from ce5g_tpu.estimators.api import estimate_batch as j_estimate_batch
    from ce5g_torch.estimators import estimate_batch

    jcfg, jf, tf = pattern_frames[pattern]
    np.testing.assert_array_equal(tf.pilot_mask.numpy(), np.asarray(jf.pilot_mask))
    grams = []
    solve = mmse_mod.hpd_solve
    monkeypatch.setattr(mmse_mod, "hpd_solve", lambda g, r: (grams.append(g), solve(g, r))[1])
    got = estimate_batch(tf, cfg=port_cfg(jcfg), estimator=estimator, method=method,
                         device="cpu").numpy()
    fn = functools.partial(j_estimate_batch, cfg=jcfg, estimator=estimator, method=method)
    want = np.asarray(jax.jit(fn)(jf))
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    err = np.abs(got - want).max() / rms
    if grams:
        cond = torch.linalg.cond(grams[0].to(torch.complex128)).tolist()
        print(f"{pattern} mmse_full Woodbury system: condition "
              + ", ".join(f"{c:.3g}" for c in cond) + f"; max error {err:.2e} of the rms")
    assert err <= tol


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("case", ["comb", "block"])
def test_slot_form_on_regular_pilots_matches_xla(case, method):
    """The slot form on comb and block pilots against the JAX package's
    XLA branch (a block column holds one or two pilots)."""
    from ce5g_tpu.estimators.interpolate import interpolate as j_interpolate
    from ce5g_torch.ops import hard_cases
    from ce5g_torch.ops.interp import interpolate_slots

    c = hard_cases.slot_case(case, 2)
    out = interpolate_slots(c["values"], c["positions"], c["valid"], c["grid"], method).numpy()
    j_xla = jax.jit(functools.partial(j_interpolate, grid_shape=c["grid"], method=method,
                                      impl="xla"))
    for f in range(out.shape[0]):
        ref = j_xla(jnp.asarray(c["values"][f].numpy()), jnp.asarray(c["positions"][f].numpy()),
                    jnp.asarray(c["valid"][f].numpy()))
        np.testing.assert_allclose(out[f], np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("pattern", ["scattered", "comb", "block"])
def test_normalized_conv_interpolate_matches_jax(pattern):
    from ce5g_tpu.estimators import normalized_conv_interpolate as j_nci
    from ce5g_torch.estimators import normalized_conv_interpolate
    from ce5g_torch.physics import make_pattern

    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.random((2, 14 * 599)).astype(np.float32))
    mask = make_pattern(u, 14, 599, torch.tensor([0.01, 0.1]), pattern).mask.numpy()
    vals = (rng.standard_normal((2, 3, 14, 599)) + 1j * rng.standard_normal((2, 3, 14, 599)))
    vals = (vals * mask[:, None]).astype(np.complex64)
    got = normalized_conv_interpolate(torch.from_numpy(vals), torch.from_numpy(mask[:, None]))
    want = np.asarray(j_nci(jnp.asarray(vals), jnp.asarray(mask[:, None])))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(vals).max())
    # an unbatched (S, K) mask broadcasts over the leading axes
    one = normalized_conv_interpolate(torch.from_numpy(vals[0]), torch.from_numpy(mask[0]))
    np.testing.assert_allclose(one.numpy(), got[0].numpy(), rtol=0, atol=1e-6)


def test_complex_to_real_round_trip_matches_jax():
    from ce5g_tpu.utils import complex_to_real as j_c2r, real_to_complex as j_r2c
    from ce5g_torch.utils import complex_to_real, real_to_complex

    x = (np.random.default_rng(0).standard_normal((3, 4, 5)) * (1 + 2j)).astype(np.complex64)
    for axis in (-1, 0, 1):
        planar = complex_to_real(torch.from_numpy(x), axis)
        np.testing.assert_array_equal(planar.numpy(), np.asarray(j_c2r(jnp.asarray(x), axis)))
        back = real_to_complex(planar, axis)
        assert back.dtype == torch.complex64
        np.testing.assert_array_equal(back.numpy(), x)
        np.testing.assert_array_equal(back.numpy(), np.asarray(j_r2c(jnp.asarray(planar.numpy()),
                                                                     axis)))


def test_get_numpy_moves_a_tree_to_the_host():
    from ce5g_torch.utils import get_numpy

    Pair = collections.namedtuple("Pair", "a b")
    tree = {"h": torch.ones(2, dtype=torch.complex64), "rest": [Pair(torch.arange(3), 1.5), None]}
    out = get_numpy(tree)
    assert isinstance(out["h"], np.ndarray) and out["h"].dtype == np.complex64
    assert isinstance(out["rest"][0], Pair) and out["rest"][0].b == 1.5
    np.testing.assert_array_equal(out["rest"][0].a, [0, 1, 2])
    assert out["rest"][1] is None


def test_sanitize_matches_jax():
    from ce5g_tpu.utils import assert_finite as j_assert_finite, finite_report as j_finite_report
    from ce5g_torch.utils import assert_finite, debug_nans, finite_report

    Pair = collections.namedtuple("Pair", "mask values")
    bad = np.array([1.0, np.nan, np.inf, -np.inf], np.float32)
    cbad = np.array([complex(np.nan, 1.0), complex(1.0, np.inf), 1.0], np.complex64)
    tree = {"z": [np.ones(3, np.float32), bad], "a": Pair(np.arange(4), cbad),
            "ok": (np.zeros(2, np.float32),)}
    ttree = {"z": [torch.ones(3), torch.from_numpy(bad)],
             "a": Pair(torch.arange(4), torch.from_numpy(cbad)), "ok": (torch.zeros(2),)}
    jtree = jax.tree.map(jnp.asarray, tree)
    assert finite_report(ttree) == j_finite_report(jtree)
    assert list(finite_report(ttree)) == list(j_finite_report(jtree))
    ok = assert_finite(ttree)
    assert ok.dtype == torch.bool and ok.ndim == 0 and not bool(ok)
    assert bool(ok) == bool(j_assert_finite(jtree))
    good = {"x": [torch.ones(2), torch.arange(2)], "y": torch.ones(1, dtype=torch.complex64)}
    assert bool(assert_finite(good, hard=True))
    with pytest.raises(FloatingPointError, match="non-finite values in frames"):
        assert_finite(ttree, name="frames", hard=True)

    x = torch.tensor([1.0, 0.0])
    with debug_nans():
        torch.exp(x)  # finite outputs pass
        with pytest.raises(FloatingPointError, match="div"):
            torch.div(x, x)
    assert torch.isnan(x / x).any()  # off outside the scope
    with debug_nans(False):
        x / x


def test_stopwatch_and_trace(tmp_path):
    from ce5g_torch.utils import Stopwatch, annotate, trace

    sw = Stopwatch()
    calls = []
    rec = sw.measure("matmul", lambda a: (calls.append(1), a @ a)[1], torch.ones(8, 8), iters=3,
                     make_args=lambda i: (torch.full((8, 8), float(i)),))
    assert set(rec) == {"compile_s", "median_s", "best_s", "iters"}
    assert rec["iters"] == 3.0 and len(calls) == 4 and 0 <= rec["best_s"] <= rec["median_s"]
    assert sw.records["matmul"] is rec and "matmul" in sw.report().splitlines()[1]
    with trace(str(tmp_path)):
        with annotate("stage"):
            torch.ones(4).sum()
    assert list(tmp_path.glob("*.pt.trace.json"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["comb", "block"])
def test_hpd_kernel_on_regular_pilot_systems_matches_plain(card, pattern_frames, monkeypatch,
                                                           pattern):
    """The HPD kernel against its plain version on the Woodbury systems
    that comb and block frames give mmse_full."""
    import ce5g_torch.estimators.mmse as mmse_mod
    from ce5g_torch.estimators import estimate_batch
    from ce5g_torch.ops import hpd_solve as hpd_mod

    jcfg, _, tf = pattern_frames[pattern]
    seen = []
    solve = mmse_mod.hpd_solve
    monkeypatch.setattr(mmse_mod, "hpd_solve", lambda g, r: (seen.append((g, r)), solve(g, r))[1])
    estimate_batch(tf, cfg=port_cfg(jcfg), estimator="mmse_full", device="cpu")
    gram, rhs = (x.to(card) for x in seen[0])
    x, ref = hpd_mod.hpd_solve(gram, rhs).cpu(), hpd_mod.hpd_solve_plain(gram, rhs).cpu()
    assert float((x - ref).abs().max() / ref.abs().max()) < 1e-4
