"""Samples trained a second on rank 0 of a sharded cell: inner steps times u
over the timed call's wall on the host, the ranks' block layouts built
inside the call, snapshots, all-reduces and evaluations included."""


def read(ctx):
    return ctx.samples / ctx.window_s if ctx.window_s > 0 else None
