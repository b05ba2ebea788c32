"""End to end: interior cell-updates of every solve in the window
(``interior**2 * n_steps`` each) over the window's time, from the first
solve's start to the last one's end, in Gcells/s."""


def read(ctx):
    cells = ctx.interior ** 2 * ctx.config["n_steps"]
    return cells * len(ctx.solve_walls) / ctx.window_s / 1e9
