"""Share of the kernels' device time spent in the snapshot (paper Alg 1
lines 3-5): its margins, its coefficients and its scatter into z.

In stream order a snapshot is a margins launch over the N rows, the
snapshot-coefficient launch and the scatter; a margins record whose next
margins-or-coefficient record is the snapshot's coefficients is the
snapshot's own."""


def read(ctx):
    if ctx.trace is None:
        return None
    ks = ctx.trace.kernels
    total = sum(e - s for _, s, e in ks)
    snap, pending = 0.0, None
    for name, s, e in ks:
        if "snapshot_coef_kernel" in name:
            snap += e - s + (pending or 0.0)
            pending = None
        elif "block_scatter_kernel" in name:
            snap += e - s
        elif "margins_kernel" in name:
            pending = e - s
        elif "coef_kernel" in name:
            pending = None
    return snap / total if snap > 0 and total > 0 else None
