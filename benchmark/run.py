"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Standard output's last line is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which are also standard error's last
lines. Exits non-zero, printing no result, without as many cards as the
cell asks for, without the port beside the benchmark, or when the process
has loaded JAX, flax or the JAX package. Every cache the port or PyTorch
builds is kept at a fixed path inside the checkout; host work runs on one
thread.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache")

#: top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "ce5g_tpu")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def prepare_environment() -> None:
    """Before torch is imported: every cache at a fixed path inside the
    checkout, no JAX through a library, one thread of host work (the CUDA
    launches come from the main thread; idle BLAS and OpenMP pools
    spinning beside it only add noise)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731

    prepare_environment()
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)

    from benchmark.harness import runner, spec

    chips = spec.Cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    out = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                     t_start=T_START, log=log)
    found = loaded_forbidden()
    if found:
        log(f"the run loaded {', '.join(found)}: no result")
        return 4
    for line in out.pop("check_lines"):
        log(line)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
