"""Device: ``torch.cuda.max_memory_allocated()`` of the run (reset before
set-up), in GiB."""


def read(ctx):
    return ctx.memory_peak_bytes / 2 ** 30 if ctx.memory_peak_bytes else None
