"""launches_per_batch: device operations (kernels, memcpys, memsets) in
the traced stretch over the batches traced: one a launch."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    return len(tr.ops) / tr.batches
