"""Items scored per second: every item whose score reached the host in the
window, over the whole window (its start to the last score)."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return ctx.items / ctx.window_s
