"""Engine and kernels layer: device time of the port's pooling of bags that
differ in length (``ragged_sls_kernel``, ``kernels/csrc/masked_sls.cu``),
both tiers' launches, per batch, from the profiler's trace of the window."""

KERNEL = "ragged_sls_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    s = sum(sec for name, (n, sec) in ctx.trace["ops"].items()
            if KERNEL in name)
    return s / ctx.requests * 1e3 if s > 0 else None
