"""Seconds from the process's start to the window's first request: imports,
traffic, tables and weights, the system's build (nvcc on a checkout's first
run), the hot tier's placement and the warm-up."""


def read(ctx):
    return ctx.setup_s
