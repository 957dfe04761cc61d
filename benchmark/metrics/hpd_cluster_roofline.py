"""hpd_cluster_roofline: the least time of the HPD solves that the port's
'cluster' route ran, over the device time of the operations launched
inside its ``ops.hpd_solve.cluster`` spans (``harness.port_spans``), in %.
Each call solves the (B, n, n) Wiener system, n = paths × time rank, with
one right-hand side an RX antenna; its least time is the larger of its
bytes over the memory rate and its operations over the float32 peak
(``work.hpd_solve``, ``work.peaks``), whatever route runs it. None where
the reading has no such span: a port without route spans, or a cell whose
solves take another route."""
from benchmark.harness import port_spans
from benchmark.work import hpd_solve, peaks

SPAN = "ops.hpd_solve.cluster"


def read(ctx):
    if ctx.peaks is None or ctx.rank is None:
        return None
    reading = port_spans.of(ctx)
    if reading is None:
        return None
    calls = sum(row.calls for row in reading.rows if row.name == SPAN)
    device_ms = reading.device_ms_under.get(SPAN)
    if not calls or not device_ms:
        return None
    params, _ = ctx.traced_inputs()[0]
    n = max(ctx.frame_paths(params)) * ctx.rank
    nbytes, flops = hpd_solve.work(ctx.batch, n, ctx.carrier.num_rx)
    least = peaks.least_seconds(nbytes, {"fp32": flops}, ctx.peaks)
    return 100.0 * (calls / reading.batches) * least / (device_ms * 1e-3)
