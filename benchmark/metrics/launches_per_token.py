"""Model: device kernels launched in the traced part of the window over
the tokens of the requests completed in it (memory copies and sets not
counted)."""


def read(ctx):
    done = ctx.traced_work.get("completed", [])
    tokens = sum(len(r["tokens"]) for r in done)
    if ctx.trace is None or not tokens:
        return None
    return len(ctx.trace.kernels()) / tokens
