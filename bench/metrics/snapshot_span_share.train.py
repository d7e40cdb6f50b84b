"""Share of the kernels' device time spent in the snapshot, read from the
program's ``rt/snapshot`` spans: each host launch call is matched in time
order to the kernel records in start order (one stream), and a kernel is
the snapshot's when its launch lies inside an ``rt/snapshot`` span.  None
where the launches and the records differ in number, or without spans."""

from bench import spans


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    snaps = spans.named(ctx.trace, "rt/snapshot")
    launched = spans.launches(ctx.trace)
    if not snaps or len(launched) != len(ctx.trace.kernels):
        return None
    inside = sum(e - s for (_, s, e), t in zip(ctx.trace.kernels, launched)
                 if spans.within(snaps, t))
    return inside / ctx.trace.kernel_s
