"""The host's own time a step, in microseconds: the mean length of the
program's ``rt/step`` spans, less the host events inside them that wait on
the card (a full launch queue, ``cuda*Synchronize``)."""

from bench import spans


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    steps = spans.named(ctx.trace, "rt/step")
    if not steps:
        return None
    waits = [(s, e) for name, s, e in ctx.trace.host if spans.is_wait(name)]
    own = sum(e - s for s, e in steps) - spans.overlap(steps, waits)
    return 1e6 * own / len(steps)
