"""The whole step's share of the card's peak: the least time the traced
window's work could take at the H100's published peaks (bench/roofline.py),
over the window's wall, in percent."""


def read(ctx):
    return ctx.mfu_percent()
