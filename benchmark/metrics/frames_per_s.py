"""frames_per_s: every frame whose score the window computed, over the
window's whole time from its start to its closing synchronization."""


def read(ctx):
    return ctx.window.batches * ctx.batch / ctx.window.seconds
