"""Examples of every optimizer step run in the window, over the window,
which ends in a synchronize (so every step counted has completed)."""


def read(ctx):
    steps = len(ctx.work.get("train_label_lens", []))
    return steps * ctx.work["batch"] / ctx.window_s if steps else None
