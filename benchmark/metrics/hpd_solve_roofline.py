"""hpd_solve_roofline: the least time of the port's HPD solves over their
kernels' summed trace time, in %. Each call (the solve and its
refinement: two a batch) solves the (B, n, n) Wiener system, n = paths ×
time rank, with one right-hand side an RX antenna; its least time is the
larger of its bytes over the memory rate and its operations over the
float32 peak (``work.hpd_solve``, ``work.peaks``)."""
from benchmark.harness.trace import kernel_ops
from benchmark.work import hpd_solve, peaks

KERNELS = {"hpd_solve_kernel", "hpd_solve_cluster_kernel", "hpd_solve_blocked_kernel"}


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.peaks is None or ctx.rank is None:
        return None
    ops = kernel_ops(tr, KERNELS)
    if not ops:
        return None
    params, _ = ctx.traced_inputs()[0]
    n = max(ctx.frame_paths(params)) * ctx.rank
    nbytes, flops = hpd_solve.work(ctx.batch, n, ctx.carrier.num_rx)
    least = peaks.least_seconds(nbytes, {"fp32": flops}, ctx.peaks)
    return 100.0 * len(ops) * least / (sum(op.dur_us for op in ops) * 1e-6)
