"""simulate_ms: device time a batch of the operations launched under the
``bench.simulate`` span, in ms."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    return tr.span_seconds("bench.simulate") * 1e3 / tr.batches
