"""Rank 0's share of its card's peak: the least time its block's work in
the traced window could take at the H100's published peaks
(bench/roofline.py), over the window's wall, in percent."""


def read(ctx):
    return ctx.mfu_percent()
