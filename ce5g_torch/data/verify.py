"""Dataset integrity verification (reference verify_phase3_datasets.py:
24-187): schema, shape, NaN/Inf, parameter distribution, pilot-density
and LS-quality spot checks — over a manifest or a merged file. Port of
``ce5g_tpu.data.verify``, with the same checks and names; it runs on the
host over the stored arrays."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..physics.profiles import PROFILE_NAMES
from .generator import read_split

REQUIRED_KEYS = (
    "rx_symbols",
    "tx_symbols",
    "H_true",
    "H_ls",
    "pilot_mask",
    "snr_db",
    "channel_type",
    "doppler_hz",
    "pilot_density",
)


def verify_dataset(
    path: str,
    density_tol: float = 0.05,
    expected_samples: Optional[int] = None,
) -> Dict:
    """Run all checks; returns {"passed": bool, "checks": {...}, ...}.

    When ``path`` is a manifest (or ``expected_samples`` is given), the
    actual sample count is checked against the manifest's ``total`` —
    catching splits corrupted by an inconsistent resume."""
    p = Path(path)
    if expected_samples is None and p.suffix == ".json":
        expected_samples = json.loads(p.read_text()).get("total")
    arrays = read_split(path)
    checks: Dict[str, Dict] = {}

    def record(name: str, ok: bool, detail: str = ""):
        checks[name] = {"passed": bool(ok), "detail": detail}

    missing = [k for k in REQUIRED_KEYS if k not in arrays]
    record("schema", not missing, f"missing: {missing}" if missing else "all keys present")
    if missing:
        return {"passed": False, "checks": checks, "num_samples": 0}

    rx = arrays["rx_symbols"]
    ht = arrays["H_true"]
    hls = arrays["H_ls"]
    mask = arrays["pilot_mask"]
    n, s, r, k = rx.shape

    # shape law (reference verify_phase3_datasets.py:68-74; here general
    # (N,S,R,K)/(N,S,R,T,K)/(N,S,K) instead of hard-coded 14/2/599)
    shape_ok = (
        ht.ndim == 5
        and ht.shape[:3] == (n, s, r)
        and ht.shape[4] == k
        and hls.shape == ht.shape
        and mask.shape == (n, s, k)
        and arrays["snr_db"].shape == (n,)
    )
    record("shapes", shape_ok, f"rx={rx.shape} H={ht.shape} mask={mask.shape}")

    finite = all(
        np.isfinite(a).all() if a.dtype.kind != "c" else
        (np.isfinite(a.real).all() and np.isfinite(a.imag).all())
        for a in (rx, ht, hls)
    )
    record("finite", finite)

    # parameter distributions (:116-152)
    types_ok = set(np.unique(arrays["channel_type"]).tolist()) <= set(PROFILE_NAMES)
    record("channel_types", types_ok, str(np.unique(arrays["channel_type"])))
    record(
        "snr_finite",
        bool(np.isfinite(arrays["snr_db"]).all() and np.isfinite(arrays["doppler_hz"]).all()),
    )

    # pilot density within ±tol absolute (:170-178 / test_phase1 ±5%)
    measured = mask.reshape(n, -1).mean(axis=1)
    target = arrays["pilot_density"]
    record(
        "pilot_density",
        bool(np.all(np.abs(measured - target) <= density_tol)),
        f"max abs dev {np.max(np.abs(measured - target)):.4f}",
    )

    # LS-quality spot check on ≤10 samples (:155-167): LS should be in the
    # same ballpark as H_true (NMSE below +20 dB)
    m = min(10, n)
    err = np.mean(np.abs(ht[:m] - hls[:m]) ** 2, axis=(1, 2, 3, 4))
    pwr = np.mean(np.abs(ht[:m]) ** 2, axis=(1, 2, 3, 4))
    nmse = float(np.mean(err / (pwr + 1e-12)))
    record("ls_quality", nmse < 100.0, f"spot NMSE {10 * np.log10(nmse + 1e-12):.2f} dB")

    nonzero = float(np.mean(np.abs(ht) ** 2))
    record("energy", nonzero > 0, f"mean |H|^2 = {nonzero:.4g}")

    if expected_samples is not None:
        record(
            "sample_count",
            n == expected_samples,
            f"{n} samples vs manifest total {expected_samples}",
        )

    return {
        "passed": all(c["passed"] for c in checks.values()),
        "checks": checks,
        "num_samples": int(n),
    }
