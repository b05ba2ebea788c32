"""Host-to-device copies: HtoD memcpy bytes over their device time, from
the profiler's trace, in GB/s."""


def read(ctx):
    return ctx.trace.copy_rate("HtoD") if ctx.trace else None
