"""Share of the traced window in which the card was idle while the host was
outside every inner step (the draw, the snapshot's launches, the
evaluation's wait, the flush, the solve's entry and exit):
``device_idle_share.train`` less ``step_idle_share.train``."""

from bench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    idle, step = ctx.idle_share(), spans.step_idle_s(ctx.trace)
    return None if idle is None or step is None else idle - step / ctx.window_s
