"""profile_gram_roofline: the least time of the E and D sums that each frame
needs for its own profile, over the device time of the operations launched
inside the port's ``mmse_full.profiles`` spans (``harness.port_spans``), in
%. The least time of a traced batch is the larger of its bytes over the
memory rate and its float64 operations over the float64 peak
(``work.profile_gram``, ``work.peaks``), with each frame's paths and pilots;
the mean over the traced batches is taken. None where the reading has no
such span: a port from before it."""
from benchmark.harness import port_spans
from benchmark.work import peaks, profile_gram

SPAN = "mmse_full.profiles"


def read(ctx):
    if ctx.peaks is None:
        return None
    reading = port_spans.of(ctx)
    if reading is None:
        return None
    calls = sum(row.calls for row in reading.rows if row.name == SPAN)
    device_ms = reading.device_ms_under.get(SPAN)
    if not calls or not device_ms:
        return None
    c = ctx.carrier
    least = []
    for params, pattern in ctx.traced_inputs():
        nbytes, flops = profile_gram.work(c.num_symbols, c.num_rx, c.num_subcarriers,
                                          ctx.frame_paths(params), pattern.num_pilots.tolist())
        least.append(peaks.least_seconds(nbytes, {"fp64": flops}, ctx.peaks))
    return 100.0 * (calls / reading.batches) * (sum(least) / len(least)) / (device_ms * 1e-3)
