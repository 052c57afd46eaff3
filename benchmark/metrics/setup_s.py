"""Set-up: from the start of the run to the first moment of the window
(weights drawn, libraries built or loaded, engine or train state made,
warm-up done, the device synchronized)."""


def read(ctx):
    return ctx.setup_s
