"""The whole step's share of the card's float32 peak, in %: operations per
item (``reference/<family>.py: flops_per_item``, from the configuration's
widths) times the traced window's items per second, over 67 TFLOP/s."""
from bench.yardstick import FP32_FLOPS_PER_S


def read(ctx):
    if ctx.trace is None:
        return None
    rate = ctx.items / ctx.window_s
    return 100.0 * ctx.flops_per_item * rate / FP32_FLOPS_PER_S
