"""The port's demonstration notebook against the JAX package's.

notebooks/01_complete_demonstration_torch.ipynb follows cells 1-5 of
notebooks/01_complete_demonstration.ipynb. Its cells that carry no 'plot'
tag run here on the CPU (``DEVICE = "cpu"``, 4 frames a sweep point, three
SNRs), with ``draw`` replaced by the JAX package's draws for the notebook's
keys: key(0) for the single frame, split(key(100 + i), B) for sweep point
i. The JAX notebook's computation runs on the same keys, and every NMSE
agrees within 0.01 dB up to 20 dB. At 30 dB mmse_full is held to the
port's float64 plain path instead: the JAX package finishes its Woodbury
solve with a difference of nearly equal vectors over σ² (see
tests/test_torch_woodbury.py), so its float32 result there is its rounding,
not the estimator.
"""
import functools
import json

import jax
import numpy as np
import pytest

import chip_smoke
from ce5g_torch.estimators import estimate_batch
from ce5g_torch.utils import nmse_db

from _torch_parity import jax_draws, port_cfg

B = 4
SNRS = [-5.0, 10.0, 30.0]
ESTIMATORS = ("ls", "mmse", "mmse_full")
HELD_TO_JAX_DB = 20.0


def _jax_keys(n, seed):
    return jax.random.key(seed)[None] if n == 1 else jax.random.split(jax.random.key(seed), n)


def _jax_notebook(jcfg):
    """Cells 2, 3 and 5 of the JAX notebook at B frames and SNRS: the
    single frame's NMSE and the sweep's, by estimator. Each step is jitted
    once at B frames (JAX compiles each shape anew): the single frame is
    simulated from key(0) into every row of a batch, and its row read
    back, as estimate_batch vmaps estimate_frame over the rows."""
    import jax.numpy as jnp
    from ce5g_tpu.estimators import estimate_batch as j_estimate_batch
    from ce5g_tpu.physics import PROFILE_INDEX, FrameParams
    from ce5g_tpu.physics import simulate_batch as j_simulate_batch
    from ce5g_tpu.physics import table_for as j_table_for
    from ce5g_tpu.utils import evaluate_estimator as j_evaluate
    from ce5g_tpu.utils import nmse_db as j_nmse_db

    table = j_table_for(jcfg)

    @jax.jit
    def simulate(keys, snr):
        p = FrameParams(jnp.full((B,), PROFILE_INDEX["EVA"], jnp.int32), jnp.full((B,), 50.0),
                        jnp.full((B,), snr), jnp.full((B,), 0.1))
        return j_simulate_batch(keys, p, cfg=jcfg, table=table)

    estimate = {est: jax.jit(functools.partial(j_estimate_batch, cfg=jcfg, estimator=est,
                                               table=table))
                for est in ESTIMATORS}
    frames = simulate(jnp.stack([jax.random.key(0)] * B), 15.0)
    frame_db = {est: float(j_evaluate(frames.channel[0], fn(frames)[0])["nmse_db"])
                for est, fn in estimate.items()}
    curves = {est: [] for est in ESTIMATORS}
    for i, snr in enumerate(SNRS):
        frames = simulate(_jax_keys(B, 100 + i), snr)
        for est, fn in estimate.items():
            curves[est].append(float(j_nmse_db(frames.channel, fn(frames))))
    return frame_db, curves


@pytest.fixture(scope="module")
def runs():
    """The port's notebook on the JAX package's draws, and the JAX
    notebook's computation on the same keys."""
    from ce5g_tpu import ExperimentConfig as JConfig

    jcfg = JConfig()

    def jax_draw(params, seed):
        return jax_draws(_jax_keys(params.profile_idx.shape[0], seed), jcfg)

    ns, left_out = chip_smoke.run_notebook(chip_smoke.NOTEBOOK,
                                           {"DEVICE": "cpu", "B": B, "SNRS": SNRS},
                                           replace={"draw": jax_draw})
    assert ns["cfg"] == port_cfg(jcfg)
    return ns, left_out, _jax_notebook(jcfg)


def test_notebook_cells():
    """A parameters cell with the card as the default device; matplotlib
    imported only in the cells tagged 'plot'; the JAX notebook's steps."""
    with open(chip_smoke.NOTEBOOK) as f:
        cells = [c for c in json.load(f)["cells"] if c["cell_type"] == "code"]
    tags = [c["metadata"].get("tags", []) for c in cells]
    params = [c for c, t in zip(cells, tags) if "parameters" in t]
    assert len(params) == 1 and 'DEVICE = "cuda"' in "".join(params[0]["source"])
    for cell, t in zip(cells, tags):
        assert ("matplotlib" in "".join(cell["source"])) == ("plot" in t)
    text = "".join("".join(c["source"]) for c in cells)
    for name in ("draw_frames", "torch.Generator", "simulate_frame", "simulate_batch",
                 "estimate_frame", "estimate_batch", "evaluate_estimator"):
        assert name in text, name
    assert "jax" not in text and "ce5g_tpu" not in text


def test_notebook_single_frame_matches_jax(runs):
    ns, left_out, (frame_db, _) = runs
    assert left_out == 2
    for est in ESTIMATORS:
        assert abs(ns["frame_db"][est] - frame_db[est]) < 0.01, est
    assert ns["frame_db"]["mmse_full"] < ns["frame_db"]["mmse"] < ns["frame_db"]["ls"]


@pytest.mark.parametrize(
    "est,point",
    [(est, i) for est in ESTIMATORS for i, snr in enumerate(SNRS)
     if est != "mmse_full" or snr <= HELD_TO_JAX_DB],  # above: test_notebook_mmse_full_at_30db
    ids=lambda x: x if isinstance(x, str) else f"{SNRS[x]:g}dB",
)
def test_notebook_sweep_matches_jax(runs, est, point):
    ns, _, (_, curves) = runs
    got, ref = ns["curves"][est][point], curves[est][point]
    assert np.isfinite(got) and abs(got - ref) < 0.01, (got, ref)


def test_notebook_mmse_full_at_30db(runs):
    """The sweep's last point (30 dB) against the float64 plain path on
    its frames: each frame within 1e-4 of its rms, the NMSE within 0.01 dB."""
    ns, _, _ = runs
    frames = ns["frames"]
    assert float(frames.params.snr_db[0]) == SNRS[-1] == 30.0
    h = estimate_batch(frames, cfg=ns["cfg"], estimator="mmse_full", device="cpu")
    ref = chip_smoke.mmse_full_float64(ns["cfg"], frames)
    err = (h.to(ref.dtype) - ref).abs().flatten(1).max(1).values
    rms = (ref.abs() ** 2).flatten(1).mean(1).sqrt()
    assert bool((err <= 1e-4 * rms).all()), (err / rms).tolist()
    ref_db = float(nmse_db(frames.channel.to(ref.dtype), ref))
    assert abs(ns["curves"]["mmse_full"][-1] - ref_db) < 0.01


def test_notebook_runs_on_its_own_draws():
    """The notebook as written (its own torch.Generator draws) at 2 frames
    and one SNR: finite NMSEs, the estimators in order on the single frame."""
    ns, _ = chip_smoke.run_notebook(chip_smoke.NOTEBOOK,
                                    {"DEVICE": "cpu", "B": 2, "SNRS": [10.0]})
    assert all(np.isfinite(v[0]) for v in ns["curves"].values())
    assert ns["frame_db"]["mmse_full"] < ns["frame_db"]["mmse"] < ns["frame_db"]["ls"]
