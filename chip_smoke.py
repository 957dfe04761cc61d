#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ce5g_torch) on one NVIDIA card.

    python3 path/to/chip_smoke.py      (from any directory)

Phases, one line each; any failure exits non-zero:
  1. setup: the card's name and power limit; build the three CUDA kernels;
  2. the HPD-solve kernel against its plain PyTorch version;
  3. the grid-interpolation kernel against its plain PyTorch version;
  4. the slot-interpolation kernel against its plain PyTorch version;
  5. the main path — draw_frames → simulate_batch → estimate_batch for
     'ls', 'mmse' and 'mmse_full' (linear) and 'ls' with 'cubic' at the
     bench config (4×4 ETU, 200 Hz, 10 dB, 10% pilots, 256 frames) — with
     NMSE, launch counts, and a check against the same path run on the
     CPU on a small batch (which also covers 'mmse' with 'cubic');
  6. the Phase-2 parity path — ce5g_torch.eval.parity.Phase2Parity at 256
     frames per cell, its comparison and interpolation tables held to the
     JAX package's results and orderings, launch counts, and the
     scipy.griddata cross-check;
  7. each kernel held against its plain version again on the inputs each
     path gave it, then times (CUDA events) of each kernel, its plain
     version and the library yardstick at those inputs, and pipeline
     frames/s.
Then one JSON line of per-kernel numbers, and last the device line.

Imports neither JAX nor ce5g_tpu. Needs a CUDA card: without one it exits
non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH = 256
NMSE_ANCHOR_DB = -1.25  # 4-TX superposition floor (T−1)/T of mmse_full
NMSE_SLACK_DB = 0.15
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
PARITY_FRAMES = 256
# Quality anchors of the parity path: the JAX package's own study at 256
# frames per cell (results/parity_phase2.json), mean NMSE dB and the band
# the port's average must fall in. The draws differ (torch.Generator vs
# threefry): the JAX per-SNR LS column alone scatters by σ ≈ 0.26 dB per
# 256-frame cell, so each band is ≥ 4σ of a 5- or 12-cell mean.
PARITY_ANCHORS_DB = {
    ("comparison", "ls:cubic"): (0.09, 0.75),
    ("comparison", "mmse:linear"): (-0.31, 0.75),
    ("comparison", "mmse_full:linear"): (-3.05, 0.3),
    ("interpolation", "nearest"): (0.46, 0.75),
    ("interpolation", "linear"): (0.21, 0.75),
    ("interpolation", "cubic"): (-0.00, 0.75),
}


def fail_unless(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hpd_problem(gen, dev, b, n, r, cond=100.0):
    import torch

    def cn(*shape):
        re = torch.randn(*shape, generator=gen, device=dev)
        im = torch.randn(*shape, generator=gen, device=dev)
        return torch.complex(re, im)

    x = cn(b, n, n)
    eye = torch.eye(n, dtype=torch.complex64, device=dev)
    gram = x @ x.mH + (n / cond) * eye
    return gram, cn(b, n, r)


def rel(a, b):
    import torch

    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def check_hpd(dev):
    import torch
    from ce5g_torch.ops import hpd_solve as hpd_mod

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for b, n, r in [(256, 45, 4), (37, 12, 3), (64, 72, 4), (16, 126, 4)]:
        gram, rhs = hpd_problem(gen, dev, b, n, r)
        x = hpd_mod.hpd_solve(gram, rhs)
        err = rel(x, hpd_mod.hpd_solve_plain(gram, rhs))
        fail_unless(err < 1e-4, f"hpd_solve {b}x{n}x{r} relative error {err:.2e} < 1e-4")
        worst = max(worst, err)
    gram, rhs = hpd_problem(gen, dev, 64, 45, 4, cond=1e4)
    x = hpd_mod.hpd_solve(gram, rhs)
    resid = rel(gram @ x, rhs)
    fail_unless(resid < 1e-3, f"hpd_solve residual {resid:.2e} < 1e-3 at cond 1e4")
    gram[5] = -torch.eye(45, dtype=gram.dtype, device=dev)
    x = hpd_mod.hpd_solve(gram, rhs)
    fail_unless(bool(torch.isnan(x[5]).all()), "non-PD system gives NaN")
    fail_unless(bool(torch.isfinite(torch.cat([x[:5], x[6:]])).all()), "PD systems finite")
    print(f"hpd_solve vs plain: worst relative error {worst:.3e}, residual {resid:.3e} "
          f"at cond 1e4, non-PD -> NaN: ok")


def random_masks(gen, dev, b, s, k, density):
    import torch
    from ce5g_torch.physics.pilots import scattered_pattern

    u = torch.rand(b, s * k, generator=gen, device=dev)
    return scattered_pattern(u, s, k, density).mask


def check_interp(dev, b):
    import torch
    from ce5g_torch.ops import interp_fused as interp_mod

    gen = torch.Generator(device=dev).manual_seed(2)
    r, s, k = 4, 14, 599
    worst = 0.0
    for density in (0.10, 0.01):
        mask = random_masks(gen, dev, b, s, k, density)
        v = torch.complex(torch.randn(b, r, s, k, generator=gen, device=dev),
                          torch.randn(b, r, s, k, generator=gen, device=dev))
        v = v * mask[:, None]
        scale = float(v.abs().max())
        for method in ("nearest", "linear"):
            out = interp_mod.interpolate_grid_fused(v, mask, method)
            err = float((out - interp_mod.interpolate_grid_plain(v, mask, method)).abs().max())
            fail_unless(err <= 1e-5 * scale,
                        f"interp {method} at {density:.0%}: max abs error {err:.2e} "
                        f"<= 1e-5 x value scale {scale:.2f}")
            worst = max(worst, err / scale)
    zero = torch.zeros(b, s, k, device=dev)
    for method in ("nearest", "linear"):
        out = interp_mod.interpolate_grid_fused(torch.zeros_like(v), zero, method)
        fail_unless(bool((out == 0).all()), f"empty mask gives zeros ({method})")
    print(f"interp_fused vs plain: {b} frames x ({r}, {s}, {k}) at 10% and 1%, "
          f"nearest+linear, worst max abs error {worst:.3e} of value scale; "
          f"empty mask -> 0: ok")


def slot_inputs(gen, dev, b, r, s, k, density, max_density):
    """Scattered pilot slots of ``b`` frames and random complex values,
    zero at invalid slots."""
    import torch
    from ce5g_torch.physics.pilots import scattered_pattern

    pat = scattered_pattern(torch.rand(b, s * k, generator=gen, device=dev), s, k, density,
                            max_density)
    p = pat.positions.shape[1]
    v = torch.complex(torch.randn(b, r, p, generator=gen, device=dev),
                      torch.randn(b, r, p, generator=gen, device=dev))
    return v * pat.valid[:, None], pat.positions, pat.valid


def check_slot_interp(dev, b):
    import torch
    from ce5g_torch.ops import interp as slot_mod

    gen = torch.Generator(device=dev).manual_seed(5)
    r, s, k = 4, 14, 599
    worst = 0.0
    cases = [(d, 0.25, (s, k), r) for d in (0.01, 0.10, 0.20)]
    cases += [(0.10, 0.15, (s, k), r), (0.10, 0.15, (6, 100), 1)]
    cases += [(0.10, 0.25, (s, k), rr) for rr in (2, 3)]
    for density, max_density, grid, rr in cases:
        v, pos, valid = slot_inputs(gen, dev, b, rr, *grid, density, max_density)
        valid[5] = 0.0  # a frame with no valid slot
        v[5] = 0.0
        scale = float(v.abs().max())
        for method in ("nearest", "linear", "cubic"):
            out = slot_mod.interpolate_slots(v, pos, valid, grid, method)
            err = float((out - slot_mod.interpolate_slots_plain(v, pos, valid, grid, method))
                        .abs().max())
            where = f"{method} at {density:.0%} (P = {pos.shape[1]}, grid {grid}, R = {rr})"
            fail_unless(err <= 1e-5 * scale,
                        f"slot interp {where}: max abs error {err:.2e} "
                        f"<= 1e-5 x value scale {scale:.2f}")
            fail_unless(bool((out[5] == 0).all()), f"slot interp {where}: empty frame -> 0")
            worst = max(worst, err / scale)
    print(f"interp (slot form) vs plain: {b} frames, R = {r} at 1%, 10%, 20% (P = 2096) and "
          f"10% (P = 1257), R = 1 on a (6, 100) grid (P = 90), R = 2 and 3 at 10% (P = 2096); "
          f"nearest+linear+cubic, worst max abs error {worst:.3e} of value scale; empty frame -> 0: ok")


def bench_setup(dev, b):
    import torch
    from ce5g_torch import ExperimentConfig, MIMOConfig
    from ce5g_torch.physics import PROFILE_INDEX, FrameParams

    cfg = ExperimentConfig(mimo=MIMOConfig(num_tx=4, num_rx=4))
    params = FrameParams(
        torch.full((b,), PROFILE_INDEX["ETU"], dtype=torch.int32, device=dev),
        torch.full((b,), 200.0, device=dev),
        torch.full((b,), 10.0, device=dev),
        torch.full((b,), 0.1, device=dev),
    )
    return cfg, params


MAIN_PAIRS = (("ls", "linear"), ("mmse", "linear"), ("mmse_full", "linear"), ("ls", "cubic"))


def run_path(dev, cfg, params, draws, pairs=MAIN_PAIRS):
    """simulate → estimate with each (estimator, method) →
    {name: (estimate, NMSE dB)}, named by the estimator alone for 'linear'."""
    from ce5g_torch.estimators import estimate_batch
    from ce5g_torch.physics import simulate_batch
    from ce5g_torch.utils import nmse_db

    frames = simulate_batch(draws, params, cfg=cfg, device=dev)
    out = {}
    for est, method in pairs:
        h = estimate_batch(frames, cfg=cfg, estimator=est, method=method, device=dev)
        name = est if method == "linear" else f"{est}:{method}"
        out[name] = (h, float(nmse_db(frames.channel, h)))
    return frames, out


class capturing:
    """Within the block, the kernel wrappers as the estimators call them
    record the first arguments each is called with (in ``self.args``,
    by kernel name)."""

    def __init__(self):
        import ce5g_torch.estimators.interpolate as interp_est
        import ce5g_torch.estimators.mmse as mmse_est

        self.sites = [(mmse_est, "hpd_solve", "hpd_solve"),
                      (interp_est, "interpolate_grid_fused", "interp_fused"),
                      (interp_est, "interpolate_slots", "interp")]
        self.args = {}

    def __enter__(self):
        self.real = [getattr(mod, attr) for mod, attr, _ in self.sites]
        for (mod, attr, name), fn in zip(self.sites, self.real):
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def wrapped(*args):
            self.args.setdefault(name, args)
            return fn(*args)
        return wrapped

    def __exit__(self, *exc):
        for (mod, attr, _), fn in zip(self.sites, self.real):
            setattr(mod, attr, fn)


def reset_launches():
    from ce5g_torch.ops import hpd_solve, interp, interp_fused

    hpd_solve.launches = interp_fused.launches = interp.launches = 0


def read_launches():
    from ce5g_torch.ops import hpd_solve, interp, interp_fused

    return {"hpd_solve": hpd_solve.launches, "interp_fused": interp_fused.launches,
            "interp": interp.launches}


def main_path(dev, b):
    """The bench-config main path with the launch counters read around it.
    Returns the counts and the kernels' main-path inputs."""
    import torch
    from ce5g_torch.physics import draw_frames

    cfg, params = bench_setup(dev, b)
    with capturing() as cap:
        gen = torch.Generator(device=dev).manual_seed(0)
        reset_launches()
        draws = draw_frames(gen, params, cfg, device=dev)
        frames, out = run_path(dev, cfg, params, draws)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = read_launches()

    for est, (h, db) in out.items():
        fail_unless(tuple(h.shape) == tuple(frames.channel.shape), f"{est} estimate shape")
        fail_unless(bool(torch.isfinite(h).all()), f"{est} estimate finite")
    full_db = out["mmse_full"][1]
    fail_unless(abs(full_db - NMSE_ANCHOR_DB) <= NMSE_SLACK_DB,
                f"mmse_full NMSE {full_db:.3f} dB within {NMSE_SLACK_DB} dB of "
                f"{NMSE_ANCHOR_DB} dB")
    print("main path (4x4 ETU 200 Hz 10 dB 10% pilots, {} frames): NMSE dB ".format(b)
          + ", ".join(f"{est} {db:.4f}" for est, (_, db) in out.items()))
    return cfg, params, launches, cap.args


def check_against_cpu(dev, b=8):
    """The main path on the card against the same path on the CPU (the
    kernels' plain versions) with the same draws, on a small batch."""
    import torch
    from ce5g_torch.physics import FrameDraws, FrameParams, draw_frames

    cfg, params = bench_setup(dev, b)
    draws = draw_frames(torch.Generator(device=dev).manual_seed(3), params, cfg, device=dev)
    cpu = torch.device("cpu")
    pairs = MAIN_PAIRS + (("mmse", "cubic"),)
    _, on_card = run_path(dev, cfg, params, draws, pairs)
    _, on_cpu = run_path(
        cpu, cfg, FrameParams(*(x.cpu() for x in params)), FrameDraws(*(x.cpu() for x in draws)),
        pairs,
    )
    parts = []
    for est in on_card:
        (h_card, db_card), (h_cpu, db_cpu) = on_card[est], on_cpu[est]
        rms = float((h_cpu.abs() ** 2).mean().sqrt())
        err = float((h_card.cpu() - h_cpu).abs().max()) / rms
        tol = 1e-3 if est == "mmse_full" else 1e-4  # Woodbury cancellation
        fail_unless(err <= tol, f"{est} card vs CPU max error {err:.2e} of rms <= {tol}")
        fail_unless(abs(db_card - db_cpu) < 0.01, f"{est} card vs CPU NMSE within 0.01 dB")
        parts.append(f"{est} {err:.2e}")
    print(f"card vs CPU on {b} frames, max error of rms: " + ", ".join(parts))


def parity_path(dev):
    """The Phase-2 parity study at PARITY_FRAMES frames per cell, with the
    launch counters read around it. Returns the counts, the first inputs
    of each kernel in the run (the slot kernel's is 'cubic': the study's
    first call is ls:cubic), and the study's wall time."""
    import torch
    from ce5g_torch.eval.parity import Phase2Parity, griddata_cross_check

    with capturing() as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launches()
        study = Phase2Parity(frames=PARITY_FRAMES, device=dev)
        comp = study.comparison_table()
        interp = study.interpolation_table()
        torch.cuda.synchronize()
        launches = read_launches()
        wall_s = time.perf_counter() - t0

    print(f"parity path ({PARITY_FRAMES} frames/cell, 17 cells) in {wall_s:.2f} s; "
          "comparison NMSE dB per SNR: " + json.dumps(comp["per_snr"]))
    fail_unless(launches["interp"] >= 17, f"interp launched >= 17 times: {launches}")
    fail_unless(launches["interp_fused"] > 0 and launches["hpd_solve"] > 0,
                f"interp_fused and hpd_solve launched on the parity path: {launches}")
    tables = {"comparison": comp["avg_db"], "interpolation": interp["avg_db"]}
    for (table, name), (anchor, band) in PARITY_ANCHORS_DB.items():
        got = tables[table][name]
        print(f"  {table} {name}: {got:.4f} dB (JAX package {anchor:+.2f} ± {band})")
        fail_unless(abs(got - anchor) <= band,
                    f"{table} {name} {got:.3f} dB within {band} dB of {anchor} dB")
    avg = comp["avg_db"]
    fail_unless(avg["mmse_full:linear"] < avg["mmse:linear"] - 1.0,
                "mmse_full beats diagonal mmse by > 1 dB")
    ia = interp["avg_db"]
    fail_unless(ia["cubic"] < ia["linear"] < ia["nearest"],
                f"cubic < linear < nearest on the 12-cell averages: {ia}")
    print(f"  interpolation wins {json.dumps(interp['wins'])}; orderings: ok")
    cross = griddata_cross_check(study.cfg, frames=8, device=dev)
    delta = {m: r["delta_db"] for m, r in cross.items()}
    fail_unless(abs(delta["nearest"]) < 0.3 and abs(delta["linear"]) < 0.75
                and delta["cubic"] < 0.5, f"griddata cross-check deltas in bounds: {delta}")
    print("griddata cross-check (8 frames), delta dB: "
          + ", ".join(f"{m} {d:+.4f}" for m, d in delta.items()) + ": ok")
    fail_unless(cap.args["interp"][-1] == "cubic", "the parity path's first slot call is cubic")
    return launches, cap.args, wall_s


def hold_against_plain(path, captured):
    """Each kernel against its plain version on the inputs ``path`` gave
    it, at the tolerances of phases 2-4. Returns the max abs errors."""
    from ce5g_torch.ops import hpd_solve as hpd_mod
    from ce5g_torch.ops import interp as slot_mod
    from ce5g_torch.ops import interp_fused as interp_mod

    gram, rhs = captured["hpd_solve"]
    x, x_plain = hpd_mod.hpd_solve(gram, rhs), hpd_mod.hpd_solve_plain(gram, rhs)
    errs = {"hpd_solve": float((x - x_plain).abs().max())}
    hpd_rel = rel(x, x_plain)
    vals, mask, method = captured["interp_fused"]
    errs["interp_fused"] = float((interp_mod.interpolate_grid_fused(vals, mask, method)
                                  - interp_mod.interpolate_grid_plain(vals, mask, method))
                                 .abs().max())
    fused_scale = float(vals.abs().max())
    slot_args = captured["interp"]
    errs["interp"] = float((slot_mod.interpolate_slots(*slot_args)
                            - slot_mod.interpolate_slots_plain(*slot_args)).abs().max())
    slot_scale = float(slot_args[0].abs().max())
    print(f"{path} inputs, kernel vs plain: hpd_solve {tuple(gram.shape)} x {rhs.shape[-1]} "
          f"relative error {hpd_rel:.3e} (max abs {errs['hpd_solve']:.3e}); interp_fused "
          f"{tuple(vals.shape)} {method} max abs {errs['interp_fused']:.3e} of scale "
          f"{fused_scale:.3f}; interp {tuple(slot_args[0].shape)} P = {slot_args[1].shape[1]} "
          f"{slot_args[-1]} max abs {errs['interp']:.3e} of scale {slot_scale:.3f}")
    fail_unless(hpd_rel < 1e-4, f"{path} hpd_solve relative error {hpd_rel:.2e} < 1e-4")
    fail_unless(errs["interp_fused"] <= 1e-5 * fused_scale,
                f"{path} interp_fused max abs error <= 1e-5 x value scale")
    fail_unless(errs["interp"] <= 1e-5 * slot_scale,
                f"{path} interp max abs error <= 1e-5 x value scale")
    return errs


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    from ce5g_torch.device import resolve_device
    from ce5g_torch.ops import _build
    from ce5g_torch.ops import hpd_solve as hpd_mod
    from ce5g_torch.ops import interp as slot_mod
    from ce5g_torch.ops import interp_fused as interp_mod
    from ce5g_torch.physics import draw_frames, simulate_batch
    from ce5g_torch.estimators import estimate_batch
    from ce5g_torch.utils import nmse_db

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    _build.build()
    print(f"build: {time.time() - t0:.1f} s for {len(_build.KERNELS)} kernels (sm_90a)")

    check_hpd(dev)
    check_interp(dev, BATCH)
    check_slot_interp(dev, BATCH)
    cfg, params, launches, captured = main_path(dev, BATCH)
    fail_unless(all(n > 0 for n in launches.values()), f"kernels launched on the main path: {launches}")
    print("kernels launched on the main path: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check_against_cpu(dev)
    parity_launches, parity_args, parity_s = parity_path(dev)
    print("kernels launched on the parity path: "
          + ", ".join(f"{k} {v}" for k, v in parity_launches.items()))

    # 7. each kernel against its plain version on each path's inputs, then
    # times: hpd_solve and interp_fused at the main path's inputs, interp
    # at the parity path's (cubic, R = 2, P = 2096) and, printed apart, at
    # the main path's (cubic, R = 4, P = 1257)
    main_errs = hold_against_plain("main path", captured)
    parity_errs = hold_against_plain("parity path", parity_args)
    gram, rhs = captured["hpd_solve"]
    vals, mask, method = captured["interp_fused"]
    slot_args = parity_args["interp"]
    bench_slot = captured["interp"]
    b, n, r = rhs.shape
    hpd_bound = bound(*hpd_mod.work(b, n, r))
    interp_bound = bound(*interp_mod.work(mask, vals.shape[1], method))
    slot_bound = bound(*slot_mod.work(*slot_args))
    kernels = [
        {
            "name": "hpd_solve", "route": "cuda", "source": "ce5g_torch/csrc/hpd_solve.cu",
            "replaces": "ce5g_tpu/ops/hpd_solve_pallas.py:45",
            "launches": launches["hpd_solve"], "max_abs_err": main_errs["hpd_solve"],
            "ms": cuda_ms(lambda: hpd_mod.hpd_solve(gram, rhs)),
            "plain_ms": cuda_ms(lambda: hpd_mod.hpd_solve_plain(gram, rhs)),
            "bound_ms": hpd_bound[0], "bound_by": hpd_bound[1],
            "library_ms": cuda_ms(lambda: torch.linalg.solve(gram, rhs)),
        },
        {
            "name": "interp_fused", "route": "cuda", "source": "ce5g_torch/csrc/interp_fused.cu",
            "replaces": "ce5g_tpu/ops/interp_fused_pallas.py:92",
            "launches": launches["interp_fused"], "max_abs_err": main_errs["interp_fused"],
            "ms": cuda_ms(lambda: interp_mod.interpolate_grid_fused(vals, mask, method)),
            "plain_ms": cuda_ms(lambda: interp_mod.interpolate_grid_plain(vals, mask, method)),
            "bound_ms": interp_bound[0], "bound_by": interp_bound[1],
            "library_ms": None,
        },
        {
            "name": "interp", "route": "cuda", "source": "ce5g_torch/csrc/interp.cu",
            "replaces": "ce5g_tpu/ops/interp_pallas.py:49",
            "launches": parity_launches["interp"], "max_abs_err": parity_errs["interp"],
            "ms": cuda_ms(lambda: slot_mod.interpolate_slots(*slot_args)),
            "plain_ms": cuda_ms(lambda: slot_mod.interpolate_slots_plain(*slot_args)),
            "bound_ms": slot_bound[0], "bound_by": slot_bound[1],
            "library_ms": None,
        },
    ]
    shapes = {"hpd_solve": tuple(gram.shape), "interp_fused": tuple(vals.shape),
              "interp": tuple(slot_args[0].shape) + (slot_args[-1],)}
    for kern in kernels:
        print(f"{kern['name']}: kernel {kern['ms']:.4f} ms, plain {kern['plain_ms']:.4f} ms, "
              f"bound {kern['bound_ms']:.4f} ms ({kern['bound_by']}), library "
              f"{kern['library_ms'] if kern['library_ms'] is None else round(kern['library_ms'], 4)} ms "
              f"at {shapes[kern['name']]}")
    bench_bound = bound(*slot_mod.work(*bench_slot))
    print(f"interp at the main path's ls:cubic inputs {tuple(bench_slot[0].shape)} "
          f"P = {bench_slot[1].shape[1]}: kernel "
          f"{cuda_ms(lambda: slot_mod.interpolate_slots(*bench_slot)):.4f} ms, plain "
          f"{cuda_ms(lambda: slot_mod.interpolate_slots_plain(*bench_slot)):.4f} ms, bound "
          f"{bench_bound[0]:.4f} ms ({bench_bound[1]})")

    # pipeline: fresh draws → simulate → mmse_full → NMSE, host clock
    gen = torch.Generator(device=dev).manual_seed(4)

    def pipeline(estimator, method="linear"):
        draws = draw_frames(gen, params, cfg, device=dev)
        frames = simulate_batch(draws, params, cfg=cfg, device=dev)
        h = estimate_batch(frames, cfg=cfg, estimator=estimator, method=method, device=dev)
        return float(nmse_db(frames.channel, h))

    rates = {}
    for estimator, method in (("mmse_full", "linear"), ("ls", "linear"), ("ls", "cubic")):
        for _ in range(3):
            pipeline(estimator, method)
        torch.cuda.synchronize()
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            pipeline(estimator, method)
        torch.cuda.synchronize()
        name = estimator if method == "linear" else f"{estimator}:{method}"
        rates[name] = BATCH * reps / (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    pipeline("mmse_full")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"pipeline (draw+simulate+estimate+NMSE, batch {BATCH}): "
          + ", ".join(f"{e} {v:.1f} frames/s" for e, v in rates.items())
          + f"; peak memory {peak_gib:.2f} GiB")
    print(f"parity study wall time ({PARITY_FRAMES} frames/cell, 17 cells, first run): "
          f"{parity_s:.3f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
