"""chip_smoke.py's Wiener serving anchors, recomputed from the JAX package.

Phases 9 and 11 hold the port's mean NMSE to the JAX package's on its
2000-frame SIMO test split. results_simo/identifiable_study.json took the
classical rows on a TPU, whose float32 matmuls lose precision in the
Woodbury solve of mmse_full and mmse_full_est at high SNR: its mmse_full
reads −20.44 dB at 30 dB SNR, worse than at 20 dB. The port computes in
full float32, so those two anchors are the JAX package's own estimators on
the same split in float32 on the CPU. The split is regenerated from its
deterministic keys (seed 42, split "test", as data_simo/test_manifest.json);
mmse, which has no such solve, reproduces the record exactly.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np

SPLIT_FRAMES = 2000
BATCH = 250


def _jax_test_split_nmse():
    """Per-frame NMSE of mmse_full, mmse_full_est and mmse on the JAX
    package's SIMO test split, and each frame's SNR."""
    from ce5g_tpu.config import load_config
    from ce5g_tpu.data.generator import generate_chunk_fn
    from ce5g_tpu.estimators.api import estimate_batch
    from ce5g_tpu.eval.evaluate import _frames_from_arrays, _nmse_per_sample
    from ce5g_tpu.utils.rng import split_key

    cfg = load_config("configs/simo_identifiable.yaml")
    chunk = generate_chunk_fn(cfg)
    estimators = {e: jax.jit(functools.partial(estimate_batch, cfg=cfg, estimator=e))
                  for e in ("mmse_full", "mmse_full_est", "mmse")}
    key = split_key(cfg.seed, "test")
    nmse = {e: [] for e in estimators}
    snr = []
    for start in range(0, SPLIT_FRAMES, BATCH):
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(start, start + BATCH))
        arrays = {k: np.asarray(v) for k, v in chunk(keys).items()}
        frames = _frames_from_arrays(arrays, np.arange(BATCH), cfg)
        for e, fn in estimators.items():
            nmse[e].append(_nmse_per_sample(arrays["H_true"], np.asarray(fn(frames))))
        snr.append(arrays["snr_db"])
    return {e: np.concatenate(v) for e, v in nmse.items()}, np.concatenate(snr)


def test_wiener_anchors_are_the_jax_package_in_float32():
    import chip_smoke

    nmse, snr = _jax_test_split_nmse()
    mean_db = {e: 10 * np.log10(v.mean()) for e, v in nmse.items()}
    with open("results_simo/identifiable_study.json") as fh:
        record = json.load(fh)
    # the same split: mmse reproduces the record to the last digit shown
    assert abs(mean_db["mmse"] - record["overall_db"]["mmse"]) < 1e-3
    assert round(mean_db["mmse"], 2) == chip_smoke.SERVING_ANCHORS_DB["mmse"]
    assert round(mean_db["mmse_full"], 2) == chip_smoke.SERVING_ANCHORS_DB["mmse_full"]
    assert round(mean_db["mmse_full_est"], 2) == chip_smoke.BLIND_ANCHORS_DB["mmse_full_est"]
    # the record is lifted at high SNR only: equal at ≤ 10 dB, ≥ 5 dB lower
    # here at 30 dB
    for est in ("mmse_full", "mmse_full_est"):
        by_snr = record["by_snr_db"][est]
        for s in (-5.0, 0.0, 5.0, 10.0):
            got = 10 * np.log10(nmse[est][snr == s].mean())
            assert abs(got - by_snr[str(s)]) < 0.02, (est, s)
        assert 10 * np.log10(nmse[est][snr == 30.0].mean()) < by_snr["30.0"] - 5.0, est
