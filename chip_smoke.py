#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ce5g_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. setup: the card's name and power limit; build both CUDA kernels;
  2. the HPD-solve kernel against its plain PyTorch version;
  3. the grid-interpolation kernel against its plain PyTorch version;
  4. the main path — draw_frames → simulate_batch → estimate_batch for
     'ls', 'mmse' and 'mmse_full' at the bench config (4×4 ETU, 200 Hz,
     10 dB, 10% pilots, 256 frames) — with NMSE, launch counts, and a
     check against the same path run on the CPU on a small batch;
  5. times (CUDA events) of each kernel, its plain version and the
     library yardstick at the main path's shapes, and pipeline frames/s.
Then one JSON line of per-kernel numbers, and last the device line.

Imports neither JAX nor ce5g_tpu. Needs a CUDA card: without one it exits
non-zero and prints no result.
"""
import json
import subprocess
import sys
import time

BATCH = 256
NMSE_ANCHOR_DB = -1.25  # 4-TX superposition floor (T−1)/T of mmse_full
NMSE_SLACK_DB = 0.15
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores


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


def run_path(dev, cfg, params, draws):
    """simulate → estimate with each estimator → {estimator: (estimate, NMSE dB)}."""
    from ce5g_torch.estimators import estimate_batch
    from ce5g_torch.physics import simulate_batch
    from ce5g_torch.utils import nmse_db

    frames = simulate_batch(draws, params, cfg=cfg, device=dev)
    out = {}
    for est in ("ls", "mmse", "mmse_full"):
        h = estimate_batch(frames, cfg=cfg, estimator=est, device=dev)
        out[est] = (h, float(nmse_db(frames.channel, h)))
    return frames, out


def main_path(dev, b):
    """The bench-config main path with the launch counters read around it.
    Returns the counts and the kernels' main-path inputs for timing."""
    import torch
    import ce5g_torch.estimators.interpolate as interp_est
    import ce5g_torch.estimators.mmse as mmse_est
    from ce5g_torch.ops import hpd_solve as hpd_mod
    from ce5g_torch.ops import interp_fused as interp_mod
    from ce5g_torch.physics import draw_frames

    cfg, params = bench_setup(dev, b)
    captured = {}

    def capture(name, fn):
        def wrapped(*args):
            captured.setdefault(name, args)
            return fn(*args)
        return wrapped

    real_hpd, real_interp = mmse_est.hpd_solve, interp_est.interpolate_grid_fused
    mmse_est.hpd_solve = capture("hpd_solve", real_hpd)
    interp_est.interpolate_grid_fused = capture("interp_fused", real_interp)
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        hpd_mod.launches = 0
        interp_mod.launches = 0
        draws = draw_frames(gen, params, cfg, device=dev)
        frames, out = run_path(dev, cfg, params, draws)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = {"hpd_solve": hpd_mod.launches, "interp_fused": interp_mod.launches}
    finally:
        mmse_est.hpd_solve, interp_est.interpolate_grid_fused = real_hpd, real_interp

    for est, (h, db) in out.items():
        fail_unless(tuple(h.shape) == tuple(frames.channel.shape), f"{est} estimate shape")
        fail_unless(bool(torch.isfinite(h).all()), f"{est} estimate finite")
    full_db = out["mmse_full"][1]
    fail_unless(abs(full_db - NMSE_ANCHOR_DB) <= NMSE_SLACK_DB,
                f"mmse_full NMSE {full_db:.3f} dB within {NMSE_SLACK_DB} dB of "
                f"{NMSE_ANCHOR_DB} dB")
    print("main path (4x4 ETU 200 Hz 10 dB 10% pilots, {} frames): NMSE dB ".format(b)
          + ", ".join(f"{est} {db:.4f}" for est, (_, db) in out.items()))
    return cfg, params, launches, captured


def check_against_cpu(dev, b=8):
    """The main path on the card against the same path on the CPU (the
    kernels' plain versions) with the same draws, on a small batch."""
    import torch
    from ce5g_torch.physics import FrameDraws, FrameParams, draw_frames

    cfg, params = bench_setup(dev, b)
    draws = draw_frames(torch.Generator(device=dev).manual_seed(3), params, cfg, device=dev)
    cpu = torch.device("cpu")
    _, on_card = run_path(dev, cfg, params, draws)
    _, on_cpu = run_path(
        cpu, cfg, FrameParams(*(x.cpu() for x in params)), FrameDraws(*(x.cpu() for x in draws))
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    from ce5g_torch.device import resolve_device
    from ce5g_torch.ops import _build
    from ce5g_torch.ops import hpd_solve as hpd_mod
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
    cfg, params, launches, captured = main_path(dev, BATCH)
    fail_unless(all(n > 0 for n in launches.values()), f"kernels launched on the main path: {launches}")
    print("kernels launched on the main path: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check_against_cpu(dev)

    # 5. times at the main path's shapes and inputs
    gram, rhs = captured["hpd_solve"]
    vals, mask = captured["interp_fused"][:2]
    method = captured["interp_fused"][2]
    hpd_err = float((hpd_mod.hpd_solve(gram, rhs) - hpd_mod.hpd_solve_plain(gram, rhs)).abs().max())
    interp_err = float((interp_mod.interpolate_grid_fused(vals, mask, method)
                        - interp_mod.interpolate_grid_plain(vals, mask, method)).abs().max())
    b, n, r = rhs.shape
    hpd_bound = bound(*hpd_mod.work(b, n, r))
    interp_bound = bound(*interp_mod.work(mask, vals.shape[1], method))
    kernels = [
        {
            "name": "hpd_solve", "route": "cuda", "source": "ce5g_torch/csrc/hpd_solve.cu",
            "replaces": "ce5g_tpu/ops/hpd_solve_pallas.py:45",
            "launches": launches["hpd_solve"], "max_abs_err": hpd_err,
            "ms": cuda_ms(lambda: hpd_mod.hpd_solve(gram, rhs)),
            "plain_ms": cuda_ms(lambda: hpd_mod.hpd_solve_plain(gram, rhs)),
            "bound_ms": hpd_bound[0], "bound_by": hpd_bound[1],
            "library_ms": cuda_ms(lambda: torch.linalg.solve(gram, rhs)),
        },
        {
            "name": "interp_fused", "route": "cuda", "source": "ce5g_torch/csrc/interp_fused.cu",
            "replaces": "ce5g_tpu/ops/interp_fused_pallas.py:92",
            "launches": launches["interp_fused"], "max_abs_err": interp_err,
            "ms": cuda_ms(lambda: interp_mod.interpolate_grid_fused(vals, mask, method)),
            "plain_ms": cuda_ms(lambda: interp_mod.interpolate_grid_plain(vals, mask, method)),
            "bound_ms": interp_bound[0], "bound_by": interp_bound[1],
            "library_ms": None,
        },
    ]
    for kern in kernels:
        print(f"{kern['name']}: kernel {kern['ms']:.4f} ms, plain {kern['plain_ms']:.4f} ms, "
              f"bound {kern['bound_ms']:.4f} ms ({kern['bound_by']}), library "
              f"{kern['library_ms'] if kern['library_ms'] is None else round(kern['library_ms'], 4)} ms "
              f"at {tuple(gram.shape) if kern['name'] == 'hpd_solve' else tuple(vals.shape)}")

    # pipeline: fresh draws → simulate → mmse_full → NMSE, host clock
    gen = torch.Generator(device=dev).manual_seed(4)

    def pipeline(estimator):
        draws = draw_frames(gen, params, cfg, device=dev)
        frames = simulate_batch(draws, params, cfg=cfg, device=dev)
        h = estimate_batch(frames, cfg=cfg, estimator=estimator, device=dev)
        return float(nmse_db(frames.channel, h))

    rates = {}
    for estimator in ("mmse_full", "ls"):
        for _ in range(3):
            pipeline(estimator)
        torch.cuda.synchronize()
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            pipeline(estimator)
        torch.cuda.synchronize()
        rates[estimator] = BATCH * reps / (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    pipeline("mmse_full")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"pipeline (draw+simulate+estimate+NMSE, batch {BATCH}): "
          + ", ".join(f"{e} {v:.1f} frames/s" for e, v in rates.items())
          + f"; peak memory {peak_gib:.2f} GiB")
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
