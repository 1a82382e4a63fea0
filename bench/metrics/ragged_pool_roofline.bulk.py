"""Engine and kernels layer: the pooling of bags that differ in length, as
a share of its roofline, in %: the mean bound of the window's batches
(``reference/<family>.py: front_end_cost`` over ``yardstick.bound_s``)
over the ``ragged_sls_kernel`` launches' device time per batch (both
tiers)."""

KERNEL = "ragged_sls_kernel"


def read(ctx):
    if ctx.trace is None or ctx.front_end_bound_s is None:
        return None
    s = sum(sec for name, (n, sec) in ctx.trace["ops"].items()
            if KERNEL in name)
    if s <= 0:
        return None
    return 100.0 * ctx.front_end_bound_s / (s / ctx.requests)
