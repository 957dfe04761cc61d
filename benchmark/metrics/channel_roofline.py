"""channel_roofline: the least time of the batch's channel and received grid
over the device time of the operations launched inside the port's
``ops.channel.<route>`` spans (``harness.port_spans``), in %. Its least time
is the larger of its bytes over the memory rate and its operations over the
float32 peak (``work.channel``, ``work.peaks``), whatever route runs it.
None where the reading has no such span: a port whose physics forms the
channel with PyTorch's operators."""
from benchmark.harness import port_spans
from benchmark.work import channel, peaks

PREFIX = "ops.channel."
PLAIN = PREFIX + "plain"


def read(ctx):
    if ctx.peaks is None:
        return None
    reading = port_spans.of(ctx)
    if reading is None:
        return None
    routes = {row.name for row in reading.rows if row.name.startswith(PREFIX)} - {PLAIN}
    calls = sum(row.calls for row in reading.rows if row.name in routes)
    device_ms = sum(reading.device_ms_under.get(name, 0.0) for name in routes)
    if not calls or not device_ms:
        return None
    params, _ = ctx.traced_inputs()[0]
    c = ctx.carrier
    nbytes, flops = channel.work(c.num_symbols, c.num_rx, c.num_tx, c.num_subcarriers,
                                 ctx.frame_paths(params))
    least = peaks.least_seconds(nbytes, {"fp32": flops}, ctx.peaks)
    return 100.0 * (calls / reading.batches) * least / (device_ms * 1e-3)
