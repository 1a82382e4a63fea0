"""Engine and kernels layer: device time of the port's fused front-end
kernels (``kernels/csrc/fused_front_end.cu``) per batch, from the profiler's
trace of the window."""

KERNEL = "fused_front_end"


def read(ctx):
    if ctx.trace is None:
        return None
    s = sum(sec for name, (n, sec) in ctx.trace["ops"].items()
            if KERNEL in name)
    return s / ctx.requests * 1e3 if s > 0 else None
