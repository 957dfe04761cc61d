"""interp_fused_roofline: the least time of the port's grid-form
interpolations over their kernels' summed trace time (the candidates
kernel of route 'global' included), in %; the work of each traced batch
from ``work.interp_fused`` on its pilot masks (made again from the
seed)."""
from benchmark.harness.trace import kernel_ops
from benchmark.work import interp_fused, peaks

KERNELS = {"interp_fused_kernel", "interp_points_kernel", "candidates_kernel"}
CALLS = {"interp_fused_kernel", "interp_points_kernel"}


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.peaks is None:
        return None
    ops = kernel_ops(tr, KERNELS)
    calls = len(kernel_ops(tr, CALLS))
    if not calls:
        return None
    least = []
    for _, pattern in ctx.traced_inputs():
        nbytes, flops = interp_fused.work(pattern.mask, ctx.carrier.num_rx, ctx.traffic["method"])
        least.append(peaks.least_seconds(nbytes, {"fp32": flops}, ctx.peaks))
    return 100.0 * calls * (sum(least) / len(least)) / (sum(op.dur_us for op in ops) * 1e-6)
