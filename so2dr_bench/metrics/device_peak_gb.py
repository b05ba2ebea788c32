"""Executor: ``torch.cuda.max_memory_allocated()`` over the window,
after ``reset_peak_memory_stats()`` at its start, in GB."""


def read(ctx):
    return ctx.window_peak_bytes / 1e9 if ctx.window_peak_bytes else None
