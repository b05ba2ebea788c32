"""End to end: seconds from the harness's first line to the window's
start: imports, the input, the plan, the kernel build where the checkout
has none yet, and the warm-up solve."""


def read(ctx):
    return ctx.setup_s
