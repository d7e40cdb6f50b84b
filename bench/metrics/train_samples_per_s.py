"""Samples trained a second: inner steps times u over the timed call's wall
on the host, its snapshots, flushes and evaluations included."""


def read(ctx):
    return ctx.samples / ctx.window_s if ctx.window_s > 0 else None
