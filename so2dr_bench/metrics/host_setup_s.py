"""Executor: host time of a solve outside the plan's ops, mean per
solve: the benchmark's clock around ``execute`` less the sum of the
program's ``ExecStats.op_wall_s`` (the domain copy, page-locking and
unlocking, runtime set-up)."""


def read(ctx):
    if not ctx.op_wall_sums:
        return None
    return sum(w - o for w, o in zip(ctx.solve_walls, ctx.op_wall_sums)) \
        / len(ctx.op_wall_sums)
