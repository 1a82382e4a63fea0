"""Seam layer: device time of host-to-device copies per batch, from the
profiler's trace of the window."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = sum(sec for name, (n, sec) in ctx.trace["ops"].items()
            if "HtoD" in name)
    return s / ctx.requests * 1e3 if s > 0 else None
