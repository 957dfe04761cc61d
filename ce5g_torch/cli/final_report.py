"""Final aggregate report CLI (reference run_phase10_final_report.py).

Port of scripts/final_report.py. Builds <results-dir>/FINAL_REPORT.md: a
curated headline section (per-model test NMSE/latency, classical
baselines, the information-floor finding), the training-curve figure,
then the full JSON artifact dump (reference :162-339 aggregates phase
JSONs the same way).

The headline's throughput line reads ``<results-dir>/bench.json``, as
``python -m ce5g_torch.cli.bench --out`` writes it, and its "Roofline
(train steps)" section the ``train_step*`` cells that carry ``mfu`` in
``<results-dir>/benchmark_suite.json``, as ``python -m
ce5g_torch.cli.benchmark_suite --train --out`` writes it. Each is read
only from a file that names its ``card``: the JAX script's inputs
(``BENCH_r*.json`` at the root of the repository, its own
``benchmark_suite.json``) hold TPU measurements and name none, so no TPU
number enters this report. Every other section reads the directories it
is given: ``--results-dir``, ``--model-dir`` and ``--study-dir``.

    python -m ce5g_torch.cli.final_report --results-dir DIR [--model-dir DIR] [--no-plots]
"""
from __future__ import annotations

import json
from pathlib import Path

from ..eval import generate_final_report, plot_training_curves
from ._common import load_cfg, make_parser, parse


def _f(v, spec=".2f"):
    """Defensive format: '—' for missing values."""
    try:
        return format(v, spec)
    except (TypeError, ValueError):
        return "—"


def _get(d, *keys, default=None):
    for k in keys:
        if not isinstance(d, dict) or k not in d:
            return default
        d = d[k]
    return d


def _port_result(path: Path):
    """The JSON object at ``path`` if the port wrote it (it names its
    ``card``), else None."""
    if not path.exists():
        return None
    d = json.loads(path.read_text())
    return d if isinstance(d, dict) and d.get("card") else None


def build_headline(results_dir: Path, model_dir: Path,
                   study_dir: Path = Path("results_simo")) -> str:
    """The headline's markdown from the files in ``results_dir`` and
    ``study_dir``: the JAX script's text, its throughput line and roofline
    section taken from the port's own results only."""
    lines = []
    bench = _port_result(results_dir / "bench.json")
    if bench:
        lines += [
            f"- **Throughput**: {_f(bench.get('value'), '.0f')} {bench.get('unit')} "
            f"on one card ({bench['card']}; bench.json).",
        ]
    diag = results_dir / "plateau_diagnosis.json"
    if diag.exists():
        d = json.loads(diag.read_text())
        fl = d.get("analytic_floor_db")
        sv = d.get("slice00_db", {})
        lines += [
            f"- **Information floor**: the reference-parity dataset "
            f"transmits the same pilot grid on every TX antenna, capping "
            f"every estimator at NMSE = (T−1)/T = {_f(fl)} dB "
            f"(full-tensor basis; {_f(sv.get('sum_oracle'))} "
            "dB on the models' per-sample slice basis) — see "
            "PLATEAU_DIAGNOSIS.md.",
        ]
        if "cnn_wiener" in sv and "mmse_full" in sv:
            delta = sv["mmse_full"] - sv["cnn_wiener"]
            rel = (
                f"{_f(delta)} dB better than"
                if delta >= 0
                else f"{_f(-delta)} dB behind"
            )
            lines += [
                f"- **Best learned estimator**: `cnn_wiener` "
                f"(residual-on-Wiener head, per-sample nmse loss) at "
                f"{_f(sv['cnn_wiener'])} dB — {rel} "
                "the full-Wiener classical estimator on the same "
                "basis at roughly half its latency (a metric-alignment "
                "win; see PLATEAU_DIAGNOSIS.md).",
            ]

    ats = results_dir / "at_scale_generation.json"
    if ats.exists():
        a = json.loads(ats.read_text())
        dr = a.get("digest_run", {})
        ot = a.get("online_train", {})
        lines += [
            f"- **At-scale factory**: {dr.get('samples', 0):,} frames "
            f"through the full sim+LS pipeline at "
            f"{_f(dr.get('device_samples_per_second'), ',.0f')} samples/s "
            "sustained on one chip (digest-manifest materialization; "
            "regenerate-and-verify "
            f"{'PASS' if dr.get('verify_pass') else 'FAIL'}). "
            "Online generate→train consumes "
            f"{ot.get('total_samples', 0):,} fresh frames at "
            f"{_f(ot.get('end_to_end_samples_per_second'), ',.0f')} "
            "samples/s with no storage in the loop "
            "(at_scale_generation.json).",
        ]

    rows = []
    for f in sorted(results_dir.glob("*_test_results.json")):
        r = json.loads(f.read_text())
        name = f.stem.replace("_test_results", "")  # filename, not the
        # stored model field: variant runs (cnn_wiener_mse) share a model
        rows.append(
            (name, r.get("nmse_db"), r.get("latency_ms_per_sample"),
             r.get("params"), r.get("checkpoint_epoch"))
        )
    if rows:
        lines += [
            "",
            "### Trained models (parity test split, slice basis)",
            "",
            "| model | NMSE (dB) | ms/sample | params | best epoch |",
            "|---|---|---|---|---|",
        ]
        for m, nm, lat, p, ep in sorted(rows, key=lambda r: r[1] or 0):
            lines.append(
                f"| {m} | {_f(nm)} | {_f(lat)} | {_f(p, ',')} | {ep} |"
            )

    study = study_dir / "identifiable_study.json"
    if study.exists():
        s = json.loads(study.read_text())
        ov = s.get("overall_db", {})
        if ov:
            lines += [
                "",
                "### Identifiable-regime study (1×2 SIMO, no floor)",
                "",
                "| method | NMSE (dB) |",
                "|---|---|",
            ] + [
                f"| {k} | {_f(v)} |"
                for k, v in sorted(ov.items(), key=lambda kv: kv[1])
            ] + ["", "Full table: ORTHOGONAL_STUDY.md."]

    par = results_dir / "parity_phase2.json"
    if par.exists():
        p = json.loads(par.read_text())
        avg = _get(p, "comparison", "avg_db", default={})
        ref = _get(p, "comparison", "reference_avg_db", default={})
        if avg:
            lines += [
                "",
                "### Reference parity (phase-2 published table)",
                "",
                "| method | ours (dB) | reference (dB) |",
                "|---|---|---|",
            ] + [
                f"| {k} | {_f(v)} | {ref.get(k, '—')} |"
                for k, v in avg.items()
            ]

    suite = _port_result(results_dir / "benchmark_suite.json")
    if suite:
        tr = {k: v for k, v in suite.items() if k.startswith("train_step") and "mfu" in v}
        if tr:
            lines += ["", f"### Roofline (train steps; {suite['card']})", ""]
            for k, v in tr.items():
                lines.append(
                    f"- `{k}`: {_f(v.get('ms_per_step'), '.1f')} ms/step, "
                    f"MFU {_f(v.get('mfu'), '.1%')} (counted matmul/conv FLOPs)"
                )
    return "\n".join(lines)


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--results-dir", required=True,
                        help="the results to report on; FINAL_REPORT.md is written here")
    parser.add_argument("--model-dir", default="models")
    parser.add_argument("--study-dir", default="results_simo",
                        help="directory of identifiable_study.json")
    parser.add_argument("--no-plots", action="store_true")
    return parser


def main(argv=None) -> int:
    args, _ = parse(build_parser(), argv)
    load_cfg(args)  # a config that does not load is refused, as the JAX script does
    rd = Path(args.results_dir)
    rd.mkdir(parents=True, exist_ok=True)
    histories = {}
    for f in Path(args.model_dir).glob("*_history.json"):
        histories[f.stem.replace("_history", "")] = json.loads(f.read_text())
    lead = {}
    headline = build_headline(rd, Path(args.model_dir), Path(args.study_dir))
    if headline:
        lead["Headline results"] = headline
    if histories and not args.no_plots:
        p = rd / "training_curves.png"
        plot_training_curves(histories, p)
        lead["Training curves"] = f"![training curves]({p.name})"

    generate_final_report(args.results_dir, lead_sections=lead)
    print(f"report → {rd / 'FINAL_REPORT.md'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
