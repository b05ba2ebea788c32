"""Kernels: the fused stencil work's bound (``so2dr_bench.counts``: the
larger of bytes over the HBM rate and operations over the
configuration's peak) over the device time of every kernel the window
ran, memcpys and memsets apart, in percent.  Bucket padding, the region
sharing's concatenations and any other kernel count as time and never
as work."""
from so2dr_bench.counts import bound


def read(ctx):
    if not ctx.trace or ctx.trace.kernel_s() <= 0:
        return None
    b = bound(ctx.work, ctx.config)
    return 100.0 * b.seconds * len(ctx.solve_walls) / ctx.trace.kernel_s()
