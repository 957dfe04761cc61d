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


def _jax_channel_draws(k_pilot, k_fade, k_noise, cfg, time_domain=False):
    """The pilot uniforms, Jakes angles and phases and noise normals that
    ce5g_tpu draws from a frame's pilot, fade and noise keys
    (pilots.py:52, jakes.py:42-46, mimo.py:57-62); with ``time_domain``
    the noise is simulate_frame_time_domain's, (R, S·(fft+cp)) per part
    (simulate.py:233-241)."""
    s = cfg.ofdm.num_symbols
    k = cfg.ofdm.num_used_subcarriers
    r, t, o = cfg.mimo.num_rx, cfg.mimo.num_tx, cfg.channel.num_oscillators
    noise = (r, s * cfg.ofdm.samples_per_symbol) if time_domain else (s, r, k)
    two_pi = 2.0 * jnp.pi
    u = jax.random.uniform(k_pilot, (s * k,))
    ka, kp = jax.random.split(k_fade)
    shape = (MAX_PATHS, r, t, o)
    angles = two_pi * jax.random.uniform(ka, shape, dtype=jnp.float32)
    phases = two_pi * jax.random.uniform(kp, shape, dtype=jnp.float32)
    kr, ki = jax.random.split(k_noise)
    nr = jax.random.normal(kr, noise, jnp.float32)
    ni = jax.random.normal(ki, noise, jnp.float32)
    return u, angles, phases, nr, ni


def jax_draws(keys, cfg, orthogonal=False, time_domain=False):
    """The draws ce5g_tpu's simulate_frame makes from each key: the same
    split(key, 4) and sub-splits as physics/simulate.py:107, pilots.py:52,
    jakes.py:42-46 and mimo.py:57-62, as the port's FrameDraws."""
    s = cfg.ofdm.num_symbols
    k = cfg.ofdm.num_used_subcarriers
    t = cfg.mimo.num_tx

    def one(key):
        k_pilot, k_tx, k_fade, k_noise = jax.random.split(key, 4)
        u, angles, phases, nr, ni = _jax_channel_draws(k_pilot, k_fade, k_noise, cfg,
                                                       time_domain)
        phase = jax.random.uniform(
            k_tx, (s, t if orthogonal else 1, k), minval=0.0, maxval=2.0 * jnp.pi
        )
        return u, phase, angles, phases, nr, ni

    return FrameDraws(*(torch.tensor(np.asarray(x)) for x in jax.vmap(one)(keys)))


def jax_td_draws(keys, cfg, orthogonal=False):
    """The draws ce5g_tpu's simulate_frame_time_domain makes from each key
    (simulate.py:198-241): simulate_frame's, with the noise drawn per
    received sample."""
    return jax_draws(keys, cfg, orthogonal, time_domain=True)


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


def woodbury_mmse_full(rx_symbols, tx_grid, pilot_mask, num_tx, snr_db, freq_matrix, amp,
                       doppler_hz, symbol_duration, time_rank):
    """mmse_full in the Woodbury form that the JAX package computes
    (ce5g_tpu/estimators/mmse.py:395-419), in the dtype of its inputs:
    x = (e − √T·D·(V⊗√w)z)/σ² on the pilots, then Ĥ = R_t·x·w·F. The port
    solves the same filter by the push-through identity; in float64 the two
    forms agree to rounding. Per-frame contractions; shapes and arguments
    as ``ce5g_torch.estimators.mmse.mmse_full_estimate``."""
    from ce5g_torch.estimators.time_prior import bessel_j0, legendre_basis

    real = rx_symbols.real.dtype
    m = pilot_mask.to(real)
    s = m.shape[1]
    g = m[:, None] * rx_symbols.transpose(1, 2) / (tx_grid[:, None] + 1e-12)  # (B, R, S, K)
    w = 0.5 * amp.to(real) ** 2
    ds = torch.arange(s, dtype=real)
    rt = bessel_j0(2.0 * np.pi * doppler_hz.to(real)[:, None, None]
                   * (ds[:, None] - ds[None, :]) * symbol_duration)
    q = (torch.as_tensor(legendre_basis(s, time_rank)).to(real)
         if time_rank is not None and time_rank < s else torch.eye(s, dtype=real))
    bm = q.T @ rt @ q
    ridge = 1e-4 * bm.diagonal(dim1=-2, dim2=-1).sum(-1) / q.shape[1] + 1e-6
    v = q @ torch.linalg.cholesky(bm + ridge[:, None, None] * torch.eye(q.shape[1], dtype=real))
    e = torch.einsum("brsk,bpk->brsp", g, freq_matrix.conj())
    d = torch.einsum("bsk,bpk,bqk->bspq", m.to(e.dtype), freq_matrix.conj(), freq_matrix)
    lv = np.sqrt(num_tx) * v[:, :, None, :] * w.sqrt()[:, None, :, None]  # (B, S, P, m): L
    lv = lv.to(e.dtype)
    sigma2 = (num_tx * w.sum(-1) / 10.0 ** (snr_db.to(real) / 10.0)).clamp(min=1e-8)
    gram = torch.einsum("bspm,bspq,bsqn->bpmqn", lv.conj(), d, lv).flatten(3).flatten(1, 2)
    gram = gram + sigma2[:, None, None] * torch.eye(gram.shape[-1], dtype=real)
    rhs = torch.einsum("bspm,brsp->bpmr", lv.conj(), e).flatten(1, 2)
    z = torch.linalg.solve(gram, rhs).unflatten(1, lv.shape[-2:])  # (B, P, m, R)
    corr = torch.einsum("bspq,bsqn,bqnr->brsp", d, lv, z)
    x = (e - corr) / sigma2[:, None, None, None]
    t2 = torch.einsum("bzs,brsp->bzrp", (v @ v.transpose(1, 2)).to(x.dtype), x) * w[:, None, None]
    h = torch.einsum("bzrp,bpk->bzrk", t2, freq_matrix)
    return h[:, :, :, None, :].expand(*h.shape[:3], num_tx, h.shape[-1])
