"""Device: the share of the traced window in which no kernel, memcpy or
memset ran on the card, in percent."""


def read(ctx):
    if not ctx.trace or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
