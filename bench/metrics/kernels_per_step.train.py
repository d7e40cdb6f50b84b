"""Device kernels in the traced window over its inner steps: the launches a
step costs, the snapshot's and the evaluation's spread over the steps."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.steps
