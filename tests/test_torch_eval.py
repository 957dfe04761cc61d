"""Port parity: ce5g_torch.eval.parity (the Phase-2 study) against ce5g_tpu's.

The two packages draw their cells' frames differently (torch.Generator vs
threefry), so the tables agree only in their statistics. Frame by frame,
the same frames from ``simulate_both`` go through both packages' cell
NMSE and must agree within 0.01 dB. The study itself runs on the CPU at
``small_cfg`` with two frames per cell.
"""
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest

from ce5g_torch.eval import parity as tparity

from _torch_parity import jax_params, port_cfg, simulate_both


def _with_capacity(jcfg):
    """The study's pilot-slot capacity (max_density 0.25)."""
    return dataclasses.replace(jcfg, pilots=dataclasses.replace(jcfg.pilots, max_density=0.25))


@pytest.fixture(scope="module")
def cell_frames(cfg):
    """Four frames of the comparison cells (EVA, 50 Hz, 10% pilots) at the
    default numerology, one per SNR of 5, 10, 15 and 20 dB. As in
    tests/test_torch_estimators.py, SNR stays ≤ 20 dB: the JAX package's
    Woodbury cancellation in mmse_full grows as 1/σ², and at 25 dB its
    float32 rounding alone moves its NMSE by ≈0.01 dB."""
    jcfg = _with_capacity(cfg)
    params = jax_params([1] * 4, [50.0] * 4, [5.0, 10.0, 15.0, 20.0], [0.10] * 4)
    jf, tf = simulate_both(jcfg, params, seed=31)
    return jcfg, jf, tf


@pytest.mark.parametrize(
    "pair", [("ls", "cubic"), ("mmse", "linear"), ("mmse_full", "linear"), ("ls", "nearest")]
)
def test_cell_nmse_matches_jax(cell_frames, pair):
    from ce5g_tpu.estimators.api import estimate_batch as j_estimate_batch
    from ce5g_tpu.eval.parity import _nmse00_db as j_nmse00_db

    jcfg, jf, tf = cell_frames
    est, method = pair
    fn = functools.partial(j_estimate_batch, cfg=jcfg, estimator=est, method=method)
    ref = j_nmse00_db(jf.channel, jax.jit(fn)(jf))
    study = tparity.Phase2Parity(port_cfg(jcfg), frames=4, device="cpu")
    got = study.cell_nmse(tf, [pair])
    assert list(got) == [f"{est}:{method}"]
    assert abs(got[f"{est}:{method}"] - ref) < 0.01, (got, ref)


@pytest.fixture(scope="module")
def small_study(small_cfg):
    return tparity.Phase2Parity(port_cfg(small_cfg), frames=2, device="cpu")


def test_study_raises_pilot_capacity(small_cfg, small_study):
    assert small_cfg.pilots.max_density == 0.15
    assert small_study.cfg.pilots.max_density == 0.25
    assert small_study.cfg.ofdm == port_cfg(small_cfg).ofdm


def test_comparison_table_runs(small_study):
    comp = small_study.comparison_table()
    assert list(comp["per_snr"]) == [str(s) for s in tparity.COMPARISON_SNRS]
    for row in comp["per_snr"].values():
        assert set(row) == {"ls:cubic", "mmse:linear", "mmse_full:linear"}
        assert all(np.isfinite(v) for v in row.values())
    assert set(comp["avg_db"]) == {"ls:cubic", "mmse:linear", "mmse_full:linear"}
    assert comp["reference_avg_db"] == {"ls:cubic": 0.18, "mmse:linear": -0.98}
    # the same seed gives the same table
    assert small_study.comparison_table() == comp


def test_interpolation_table_runs(small_study):
    interp = small_study.interpolation_table()
    assert len(interp["cells"]) == 12
    assert [c["density"] for c in interp["cells"][5:9]] == list(tparity.INTERP_DENSITIES)
    assert [c["profile"] for c in interp["cells"][9:]] == list(tparity.INTERP_CHANNELS)
    assert sum(interp["wins"].values()) == 12
    assert set(interp["avg_db"]) == {"nearest", "linear", "cubic"}
    assert all(np.isfinite(v) for v in interp["avg_db"].values())


def test_griddata_cross_check_runs(small_study):
    cross = tparity.griddata_cross_check(small_study.cfg, frames=2, device="cpu")
    assert set(cross) == {"nearest", "linear", "cubic"}
    for r in cross.values():
        assert np.isclose(r["delta_db"], r["ours_db"] - r["scipy_db"])
    # nearest is the same algorithm as griddata's up to tie-breaking
    assert abs(cross["nearest"]["delta_db"]) < 0.3, cross


def test_main_writes_the_scripts_json(tmp_path):
    """``python -m ce5g_torch.cli.parity_phase2`` writes the keys of
    scripts/parity_phase2.py and its markdown table, here on a small YAML
    numerology."""
    from ce5g_torch.cli import parity_phase2

    config = tmp_path / "small.yaml"
    config.write_text(
        "ofdm: {fft_size: 64, cp_length: 8, num_symbols: 6, useful_subcarriers: 40}\n"
    )
    out = tmp_path / "out"
    rc = parity_phase2.main(["--frames", "1", "--results-dir", str(out), "--skip-scipy",
                             "--config", str(config), "--device", "cpu"])
    assert rc == 0
    d = json.loads((out / "parity_phase2.json").read_text())
    assert set(d) == {"frames_per_cell", "comparison", "interpolation",
                      "griddata_cross_check", "reference"}
    assert d["frames_per_cell"] == 1 and d["griddata_cross_check"] is None
    assert d["reference"] == tparity.REFERENCE_PHASE2
    md = (out / "parity_phase2.md").read_text()
    assert md == parity_phase2.markdown(d)
    assert "Ours: 1 frames/cell" in md and "scipy.griddata" not in md
    for snr in d["comparison"]["per_snr"]:
        assert f"| {snr} |" in md
