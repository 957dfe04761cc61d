"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ce5g_torch.config as tconfig
from ce5g_torch.physics import FrameDraws
from ce5g_torch.physics.profiles import MAX_PATHS


def port_cfg(jcfg):
    """The port's ExperimentConfig with the same values as a ce5g_tpu one."""
    subs = {
        f.name: getattr(tconfig, type(getattr(jcfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(jcfg, f.name))
        )
        for f in dataclasses.fields(jcfg)
        if dataclasses.is_dataclass(getattr(jcfg, f.name))
    }
    rest = {
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(jcfg)
        if f.name not in subs
    }
    return tconfig.ExperimentConfig(**subs, **rest)


def _jax_channel_draws(k_pilot, k_fade, k_noise, cfg):
    """The pilot uniforms, Jakes angles and phases and noise normals that
    ce5g_tpu draws from a frame's pilot, fade and noise keys
    (pilots.py:52, jakes.py:42-46, mimo.py:57-62)."""
    s = cfg.ofdm.num_symbols
    k = cfg.ofdm.num_used_subcarriers
    r, t, o = cfg.mimo.num_rx, cfg.mimo.num_tx, cfg.channel.num_oscillators
    two_pi = 2.0 * jnp.pi
    u = jax.random.uniform(k_pilot, (s * k,))
    ka, kp = jax.random.split(k_fade)
    shape = (MAX_PATHS, r, t, o)
    angles = two_pi * jax.random.uniform(ka, shape, dtype=jnp.float32)
    phases = two_pi * jax.random.uniform(kp, shape, dtype=jnp.float32)
    kr, ki = jax.random.split(k_noise)
    nr = jax.random.normal(kr, (s, r, k), jnp.float32)
    ni = jax.random.normal(ki, (s, r, k), jnp.float32)
    return u, angles, phases, nr, ni


def jax_draws(keys, cfg, orthogonal=False):
    """The draws ce5g_tpu's simulate_frame makes from each key: the same
    split(key, 4) and sub-splits as physics/simulate.py:107, pilots.py:52,
    jakes.py:42-46 and mimo.py:57-62, as the port's FrameDraws."""
    s = cfg.ofdm.num_symbols
    k = cfg.ofdm.num_used_subcarriers
    t = cfg.mimo.num_tx

    def one(key):
        k_pilot, k_tx, k_fade, k_noise = jax.random.split(key, 4)
        u, angles, phases, nr, ni = _jax_channel_draws(k_pilot, k_fade, k_noise, cfg)
        phase = jax.random.uniform(
            k_tx, (s, t if orthogonal else 1, k), minval=0.0, maxval=2.0 * jnp.pi
        )
        return u, phase, angles, phases, nr, ni

    return FrameDraws(*(torch.tensor(np.asarray(x)) for x in jax.vmap(one)(keys)))


def jax_qam_draws(keys, cfg, modulation=4):
    """The draws ce5g_tpu's simulate_qam_frame makes from each key: the
    five-way split of eval/ber.py:50 (pilot, tx, fade, noise, bits), the
    (S, K) pilot phase of :61-63 and the Bernoulli bits of :58, as the
    port's QAMDraws."""
    from ce5g_torch.eval.ber import QAMDraws

    s = cfg.ofdm.num_symbols
    k = cfg.ofdm.num_used_subcarriers
    bps = int(np.log2(modulation))

    def one(key):
        k_pilot, k_tx, k_fade, k_noise, k_bits = jax.random.split(key, 5)
        u, angles, phases, nr, ni = _jax_channel_draws(k_pilot, k_fade, k_noise, cfg)
        phase = jax.random.uniform(k_tx, (s, k), minval=0.0, maxval=2.0 * jnp.pi)
        bits = jax.random.bernoulli(k_bits, 0.5, (s * k * bps,)).astype(jnp.int32)
        return u, phase[:, None, :], angles, phases, nr, ni, bits

    *frame, bits = (torch.tensor(np.asarray(x)) for x in jax.vmap(one)(keys))
    return QAMDraws(FrameDraws(*frame), bits)


def jax_params(profile, doppler, snr, density):
    from ce5g_tpu.physics import FrameParams

    return FrameParams(
        jnp.asarray(profile, jnp.int32),
        jnp.asarray(doppler, jnp.float32),
        jnp.asarray(snr, jnp.float32),
        jnp.asarray(density, jnp.float32),
    )


def simulate_both(jcfg, params, seed=0, orthogonal=False):
    """The same frames from ce5g_tpu and from the port (on the CPU)."""
    from ce5g_tpu.physics import simulate_batch as j_simulate_batch
    from ce5g_torch.physics import FrameParams, simulate_batch

    b = params.profile_idx.shape[0]
    keys = jax.random.split(jax.random.key(seed), b)
    jf = j_simulate_batch(keys, params, cfg=jcfg, orthogonal_pilots=orthogonal)
    tf = simulate_batch(
        jax_draws(keys, jcfg, orthogonal),
        FrameParams(*(torch.tensor(np.asarray(x)) for x in params)),
        cfg=port_cfg(jcfg), orthogonal_pilots=orthogonal, device="cpu",
    )
    return jf, tf


def assert_close_to_power(actual, expected, tol):
    """max |actual − expected| ≤ tol · rms(expected), frame by frame."""
    a = np.asarray(actual)
    e = np.asarray(expected)
    axes = tuple(range(1, e.ndim))
    err = np.max(np.abs(a - e), axis=axes)
    rms = np.sqrt(np.mean(np.abs(e) ** 2, axis=axes))
    assert np.all(err <= tol * rms), err / rms


@pytest.fixture
def one_torch_thread():
    """Run the test with torch on one CPU thread. Tests that compare two
    CPU runs bit for bit need a fixed reduction order, and MKL may pick
    its thread count at run time (as a card runs one launch configuration)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
