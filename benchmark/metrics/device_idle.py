"""device_idle: the share of the traced stretch in which no operation ran
on the card, in %: 1 − (union of device activity) / traced window."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
