"""Model layer: device time of the matrix-product kernels (cuBLAS / CUTLASS
GEMMs and GEMVs of the MLPs and the projection) per batch, from the profiler's trace
of the window."""
import re

GEMM = re.compile(r"gemm|gemv|xmma|cutlass", re.IGNORECASE)


def read(ctx):
    if ctx.trace is None:
        return None
    s = sum(sec for name, (n, sec) in ctx.trace["ops"].items()
            if GEMM.search(name))
    return s / ctx.requests * 1e3 if s > 0 else None
