"""Port parity: ce5g_torch's simulator against ce5g_tpu's on the same draws.

The JAX package draws each frame's randomness from its key inside
``simulate_frame``; these tests rebuild exactly those draws with
``jax.random`` (the same split(key, 4) and sub-splits as
physics/simulate.py:107, pilots.py:52, jakes.py:42-46, mimo.py:57-62) and
hand them to the port as numpy. The pilot pattern must then be identical;
channel and rx symbols differ only by float32 summation order.
"""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ce5g_torch.physics import FrameParams, simulate_batch
from ce5g_torch.physics.profiles import MAX_PATHS

from _torch_parity import (
    assert_close_to_power,
    jax_draws,
    jax_params,
    port_cfg,
    simulate_both,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("orthogonal", [False, True])
def test_simulate_batch_matches_jax(small_cfg, orthogonal):
    params = jax_params([0, 1, 2], [10.0, 100.0, 200.0], [0.0, 10.0, 25.0],
                        [0.02, 0.10, 0.15])
    jf, tf = simulate_both(small_cfg, params, seed=3, orthogonal=orthogonal)
    for name in ("pilot_mask", "pilot_positions", "pilot_valid", "num_pilots"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)))
    np.testing.assert_allclose(tf.tx_symbols.numpy(), np.asarray(jf.tx_symbols), atol=1e-6)
    assert_close_to_power(tf.channel.numpy(), jf.channel, 1e-4)
    assert_close_to_power(tf.rx_symbols.numpy(), jf.rx_symbols, 1e-4)


def test_simulate_full_numerology_matches_jax(cfg):
    """Default numerology (14 × 599), 4×4, the bench's ETU/200 Hz/10 dB/10%."""
    from ce5g_tpu import MIMOConfig

    cfg4 = cfg.__class__(mimo=MIMOConfig(num_tx=4, num_rx=4))
    params = jax_params([2, 2], [200.0, 200.0], [10.0, 10.0], [0.10, 0.10])
    jf, tf = simulate_both(cfg4, params, seed=11)
    np.testing.assert_array_equal(tf.pilot_mask.numpy(), np.asarray(jf.pilot_mask))
    np.testing.assert_array_equal(tf.pilot_positions.numpy(), np.asarray(jf.pilot_positions))
    assert_close_to_power(tf.channel.numpy(), jf.channel, 1e-4)
    assert_close_to_power(tf.rx_symbols.numpy(), jf.rx_symbols, 1e-4)


@pytest.mark.parametrize("density", [0.0, 0.01, 0.05, 0.15])
def test_scattered_pattern_matches_jax(density):
    from ce5g_tpu.physics.pilots import scattered_pattern as j_scattered
    from ce5g_torch.physics.pilots import scattered_pattern

    s, k = 14, 599
    keys = jax.random.split(jax.random.key(7), 4)
    u = jax.vmap(lambda key: jax.random.uniform(key, (s * k,)))(keys)
    jp = jax.vmap(lambda key: j_scattered(key, s, k, density))(keys)
    tp = scattered_pattern(torch.from_numpy(np.array(u)), s, k, density)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.broadcast_to(np.asarray(b), a.shape))
    assert int(tp.mask.sum()) == 4 * int(math.floor(np.float32(s * k) * np.float32(density)))


def test_simulate_frame_is_batch_of_one(small_cfg):
    from ce5g_torch.physics import FrameDraws, simulate_frame

    params = FrameParams(torch.tensor([0, 2], dtype=torch.int32), torch.tensor([10.0, 200.0]),
                         torch.tensor([5.0, 20.0]), torch.tensor([0.05, 0.15]))
    draws = jax_draws(jax.random.split(jax.random.key(4), 2), small_cfg)
    cfg = port_cfg(small_cfg)
    batch = simulate_batch(draws, params, cfg=cfg, device="cpu")
    one = simulate_frame(FrameDraws(*(x[1] for x in draws)), FrameParams(*(x[1] for x in params)),
                         cfg=cfg, device="cpu")
    for a, b in zip(one[:-1], batch[:-1]):
        torch.testing.assert_close(a, b[1], rtol=0, atol=1e-5)


def test_pattern_rules():
    from ce5g_torch.physics.pilots import make_pattern

    u = torch.rand(1, 6 * 39)
    with pytest.raises(ValueError, match="max_density"):
        make_pattern(u, 6, 39, 0.2)
    with pytest.raises(ValueError, match="Unknown pilot pattern"):
        make_pattern(u, 6, 39, 0.1, pattern="diagonal")
    for pattern in ("comb", "block"):  # ported: tests/test_torch_patterns.py holds them
        assert make_pattern(u, 6, 39, 0.1, pattern=pattern).mask.shape == (1, 6, 39)


def test_draw_frames_law(small_cfg):
    """draw_frames: shapes, and the channel power law E|H|² = ½·Σ amp²
    (the reference's 1/sqrt(2N) Jakes normalisation)."""
    from ce5g_torch.physics import draw_frames, table_for

    b = 64
    params = FrameParams(
        torch.full((b,), 2), torch.full((b,), 50.0), torch.full((b,), 20.0),
        torch.full((b,), 0.1),
    )
    cfg = port_cfg(small_cfg)
    gen = torch.Generator().manual_seed(0)
    draws = draw_frames(gen, params, cfg, device="cpu")
    assert draws.tx_phase.shape == (b, 6, 1, 39)
    assert draws.jakes_angles.shape == (b, MAX_PATHS, 2, 2, 20)
    assert float(draws.tx_phase.min()) >= 0.0 and float(draws.tx_phase.max()) < 2 * math.pi
    frames = simulate_batch(draws, params, cfg=cfg, device="cpu")
    amp = table_for(cfg).amp_overwrite[2]
    expect = 0.5 * float(np.sum(amp ** 2))
    got = float((frames.channel.abs() ** 2).mean())
    assert abs(got - expect) < 0.15 * expect


def test_entry_points_need_cuda_or_cpu(small_cfg):
    """With no card, an entry point called without device='cpu' raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the rule is for machines without one")
    params = FrameParams(torch.zeros(1, dtype=torch.int32), torch.ones(1),
                         torch.ones(1), torch.full((1,), 0.1))
    draws = jax_draws(jax.random.split(jax.random.key(0), 1), small_cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_batch(draws, params, cfg=port_cfg(small_cfg))


def test_package_imports_without_jax():
    """The port imports with JAX unavailable, and no source names ce5g_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ce5g_tpu'] = None\n"
        "import ce5g_torch, ce5g_torch.convert, ce5g_torch.estimators, "
        "ce5g_torch.physics, ce5g_torch.ops.hpd_solve, ce5g_torch.ops.interp_fused, "
        "ce5g_torch.ops.interp, ce5g_torch.eval.parity\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
    banned = re.compile(r"^\s*(from|import)\s+(jax|ce5g_tpu)\b", re.MULTILINE)
    for src in (REPO / "ce5g_torch").rglob("*.py"):
        assert not banned.search(src.read_text()), src
