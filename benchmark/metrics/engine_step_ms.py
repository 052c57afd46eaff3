"""Serving engine: the window's wall time over the ``step()`` calls made in
it (admit, chunk and harvest together)."""


def read(ctx):
    n = ctx.work.get("steps", 0)
    return 1e3 * ctx.window_s / n if n else None
