"""Device layer: the share of the traced window in which no kernel or copy
ran on the card, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace
    if t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
