"""interp_roofline: the least time of the port's slot-form interpolations
over their kernels' summed trace time (the sort kernel of route 'tile'
included), in %; the work of each traced batch from ``work.interp`` on
its shapes and pilot counts (made again from the seed)."""
from benchmark.harness.trace import kernel_ops
from benchmark.work import interp, peaks

KERNELS = {"interp_kernel", "interp_tile_kernel", "sort_kernel"}
CALLS = {"interp_kernel", "interp_tile_kernel"}


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.peaks is None:
        return None
    ops = kernel_ops(tr, KERNELS)
    calls = len(kernel_ops(tr, CALLS))
    if not calls:
        return None
    c = ctx.carrier
    least = []
    for _, pattern in ctx.traced_inputs():
        nbytes, flops = interp.work(ctx.batch, c.num_rx, c.max_pilots, c.num_symbols,
                                    c.num_subcarriers, pattern.num_pilots.tolist(),
                                    ctx.traffic["method"])
        least.append(peaks.least_seconds(nbytes, {"fp32": flops}, ctx.peaks))
    return 100.0 * calls * (sum(least) / len(least)) / (sum(op.dur_us for op in ops) * 1e-6)
