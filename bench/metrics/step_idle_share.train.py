"""Share of the traced window in which the card was idle while the host was
inside an inner step: the parts of the idle gaps between kernels that
overlap the program's ``rt/step`` spans, over the window's wall."""

from bench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    idle = spans.step_idle_s(ctx.trace)
    return None if idle is None else idle / ctx.window_s
