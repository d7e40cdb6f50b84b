"""Seconds from the start of the process to the start of the window:
imports and CUDA, the kernel library (its build on a checkout's first
run), the data, the layout and the warm-up solve."""


def read(ctx):
    return ctx.setup_s
