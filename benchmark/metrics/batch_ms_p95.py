"""batch_ms_p95: the 95th percentile, over every batch of the window, of
the time from one batch's completion to the next's (CUDA events recorded
on the stream after each batch's score)."""
import statistics


def read(ctx):
    times = ctx.window.batch_ms
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=20)[18]
