"""nmse_roofline: the least time of the batch's score over the summed trace
time of the port's NMSE kernels (the pass and the sum of its partials),
in %; the work of a batch from ``work.nmse`` on the configuration's
shapes. None where the trace holds no such kernel (a port whose score is
PyTorch's operators)."""
from benchmark.harness.trace import kernel_ops
from benchmark.work import nmse, peaks

KERNELS = {"nmse_kernel", "nmse_finish_kernel"}
CALLS = {"nmse_kernel"}


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.peaks is None:
        return None
    ops = kernel_ops(tr, KERNELS)
    calls = len(kernel_ops(tr, CALLS))
    if not calls:
        return None
    c = ctx.carrier
    nbytes, flops = nmse.work(ctx.batch, c.num_symbols, c.num_rx, c.num_tx, c.num_subcarriers)
    least = peaks.least_seconds(nbytes, {"fp32": flops}, ctx.peaks)
    return 100.0 * calls * least / (sum(op.dur_us for op in ops) * 1e-6)
