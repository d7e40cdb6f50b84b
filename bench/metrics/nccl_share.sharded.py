"""Share of rank 0's traced window in which NCCL kernels ran on its card:
the all-reduces of the margins and the evaluation's all-gathers, waiting
for the other ranks included."""


def read(ctx):
    if ctx.trace is None:
        return None
    nccl = sum(e - s for name, s, e in ctx.trace.kernels if "nccl" in name.lower())
    return nccl / ctx.window_s if nccl > 0 else None
