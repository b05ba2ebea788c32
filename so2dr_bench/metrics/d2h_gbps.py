"""Device-to-host copies: DtoH memcpy bytes over their device time, from
the profiler's trace, in GB/s."""


def read(ctx):
    return ctx.trace.copy_rate("DtoH") if ctx.trace else None
