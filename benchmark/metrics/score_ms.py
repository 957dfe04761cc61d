"""score_ms: device time a batch of the operations launched under the
``bench.score`` span, in ms."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    return tr.span_seconds("bench.score") * 1e3 / tr.batches
