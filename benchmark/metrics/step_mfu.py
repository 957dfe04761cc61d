"""step_mfu: the whole step's share of the card's peak, in %: the least
time of a batch's required work (``work.step``: the larger of its bytes
over the memory rate and its operations, each precision over its own
peak) over the window's time a batch (host clock, the run's untraced
window). The data-dependent counts come from the traced batches' inputs,
made again from the seed."""
from benchmark.work import peaks, step


def read(ctx):
    if ctx.peaks is None or not ctx.traced:
        return None
    least = []
    for params, pattern in ctx.traced_inputs():
        w = step.work(ctx.carrier, ctx.traffic["estimator"], ctx.traffic["method"], ctx.rank,
                      ctx.frame_paths(params), pattern.num_pilots.tolist(), pattern.mask)
        least.append(peaks.least_seconds(w["bytes"], {"fp32": w["fp32"], "fp64": w["fp64"]},
                                         ctx.peaks))
    per_batch = ctx.window.seconds / ctx.window.batches
    return 100.0 * (sum(least) / len(least)) / per_batch
