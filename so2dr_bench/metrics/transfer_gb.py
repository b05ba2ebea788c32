"""Planner: H2D plus D2H bytes of one solve, from the plan's own exact
accounting (``plan.stats()``), in GB."""


def read(ctx):
    s = ctx.plan_stats
    return (s.h2d_bytes + s.d2h_bytes) / 1e9
