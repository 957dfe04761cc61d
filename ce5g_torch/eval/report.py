"""Report and figure generation.

Port of ``ce5g_tpu.eval.report``; the text is the JAX package's, so a
report from either package reads the same, apart from the final report's
title, which names the port. Parity surface: reference
src/evaluate.py:141-235 (comparison plots + JSON/text report),
run_phase5_evaluation.py:314-386 (NMSE-vs-SNR plot + markdown report
with improvement-vs-LS table) and run_phase10_final_report.py:28-391
(aggregate FINAL_REPORT.md + figures). Matplotlib is imported lazily:
it is not promised where the card is, and metric-only runs never need
it.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_comparison(results: Dict[str, Dict], out_path: str):
    """NMSE and latency bar charts (reference evaluate.py:141-187)."""
    plt = _plt()
    methods = list(results)
    nmse_db = [results[m].get("nmse_db", float("nan")) for m in methods]
    latency = [results[m].get("latency_ms_per_sample", 0.0) for m in methods]
    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    axes[0].bar(methods, nmse_db)
    axes[0].set_ylabel("NMSE (dB)")
    axes[0].set_title("Channel estimation NMSE")
    axes[0].grid(True, alpha=0.3)
    axes[1].bar(methods, latency)
    axes[1].set_ylabel("latency (ms/sample)")
    axes[1].set_title("Inference latency")
    axes[1].grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_snr_sweep(sweep: Dict[str, Dict], out_path: str):
    """NMSE-vs-SNR line plot (reference run_phase5_evaluation.py:314-340)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    for method, by_snr in sweep.items():
        snrs = sorted(float(s) for s in by_snr)
        vals = [by_snr[str(s)]["nmse_db"] for s in snrs]
        ax.plot(snrs, vals, marker="o", label=method)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("NMSE (dB)")
    ax.set_title("Channel estimation NMSE vs SNR")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_training_curves(histories: Dict[str, Dict], out_path: str):
    """Train/val curves per model (reference run_phase10:97-160)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, h in histories.items():
        ax.plot(h["train_loss"], label=f"{name} train")
        ax.plot(h["val_loss"], "--", label=f"{name} val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def generate_evaluation_report(
    results: Dict[str, Dict], out_path: str, config_summary: Optional[Dict] = None
) -> str:
    """Markdown report with improvement-vs-LS table
    (reference run_phase5_evaluation.py:342-386)."""
    lines = [
        "# Channel Estimation Evaluation Report",
        "",
        f"Generated: {time.strftime('%Y-%m-%d %H:%M:%S')}",
        "",
    ]
    if config_summary:
        lines += ["## Configuration", "", "```json",
                  json.dumps(config_summary, indent=2), "```", ""]
    lines += [
        "## Results",
        "",
        "NMSE bases: **full** = over the whole (S, R, T, K) tensor "
        "(classical estimators' native basis); **slice** = per-sample over "
        "the (rx0, tx0) slice (the models' native basis). The two are NOT "
        "comparable to each other — on the parity dataset the same "
        "estimator reads ~0.7 dB apart between bases "
        "(results/PLATEAU_DIAGNOSIS.md). Compare within a column.",
        "",
        "| Method | Source | NMSE full (dB) | NMSE slice (dB) | MSE "
        "| Latency (ms/sample) | Params |",
        "|---|---|---|---|---|---|---|",
    ]

    def _num(v, fmt=".2f"):
        return ("{:" + fmt + "}").format(v) if v is not None else "—"

    for method, r in results.items():
        if not isinstance(r, dict) or "nmse_db" not in r:
            continue
        is_model = "basis" in r and r["basis"].startswith("slice")
        full_db = None if is_model else r.get("nmse_db")
        slice_db = r.get("nmse_db_slice", r.get("nmse_db") if is_model else None)
        lat = r.get("latency_ms_per_sample")
        lat_s = _num(lat, ".3f") if lat else "— (stored)"
        lines.append(
            f"| {method} | {r.get('source', '—')} | {_num(full_db)} "
            f"| {_num(slice_db)} | {_num(r.get('mse'), '.3e')} "
            f"| {lat_s} | {r.get('params', '—')} |"
        )

    ls_full = results.get("ls", results.get("LS", {})).get("nmse_db")
    ls_slice = results.get("ls", results.get("LS", {})).get("nmse_db_slice")
    if ls_full is not None:
        lines += [
            "",
            "## Improvement vs LS (basis-consistent)",
            "",
            "Full-basis methods vs LS full; slice-basis methods vs LS slice.",
            "",
        ]
        for method, r in results.items():
            if method in ("LS", "ls") or not isinstance(r, dict):
                continue
            if "nmse_db" not in r:
                continue
            is_model = "basis" in r and r["basis"].startswith("slice")
            if is_model and ls_slice is not None:
                lines.append(
                    f"- **{method}** (slice): "
                    f"{ls_slice - r['nmse_db']:+.2f} dB vs LS slice"
                )
            elif not is_model:
                lines.append(
                    f"- **{method}** (full): "
                    f"{ls_full - r['nmse_db']:+.2f} dB vs LS full"
                )
    text = "\n".join(lines) + "\n"
    Path(out_path).write_text(text)
    return text


def generate_final_report(
    results_dir: str,
    out_name: str = "FINAL_REPORT.md",
    extra_sections: Optional[Dict[str, str]] = None,
    lead_sections: Optional[Dict[str, str]] = None,
) -> str:
    """Aggregate every results JSON + history into one markdown report
    (reference run_phase10_final_report.py:162-339). ``lead_sections``
    render before the artifact dump, ``extra_sections`` after."""
    rd = Path(results_dir)
    lines = [
        "# Final Report — 5G Channel Estimation, PyTorch/CUDA port (ce5g_torch)",
        "",
        f"Generated: {time.strftime('%Y-%m-%d %H:%M:%S')}",
        "",
    ]
    for title, body in (lead_sections or {}).items():
        lines += [f"## {title}", "", body, ""]
    for jf in sorted(rd.glob("*.json")):
        try:
            data = json.loads(jf.read_text())
        except json.JSONDecodeError:
            continue
        lines += [f"## {jf.stem}", "", "```json",
                  json.dumps(data, indent=2, default=str)[:4000], "```", ""]
    for title, body in (extra_sections or {}).items():
        lines += [f"## {title}", "", body, ""]
    text = "\n".join(lines)
    (rd / out_name).write_text(text)
    return text
