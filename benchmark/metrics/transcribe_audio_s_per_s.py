"""Audio seconds (each clip's length before padding to the 30 s window) of
the requests completed inside the window, over the window."""


def read(ctx):
    done = ctx.work.get("completed", [])
    return sum(r["audio_s"] for r in done) / ctx.window_s if done else None
