"""The kernels' share of their roofline: the least time the traced window's
work could take at the H100's published peaks (bench/roofline.py), over
the device time of every kernel the trace recorded, in percent."""


def read(ctx):
    if ctx.least_s is None or ctx.trace is None or not ctx.trace.kernels:
        return None
    return 100.0 * ctx.least_s / ctx.trace.kernel_s
