"""Share of the traced window in which no kernel ran on the card: one less
the union of the kernel intervals over the window's wall."""


def read(ctx):
    return ctx.idle_share()
