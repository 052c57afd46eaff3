"""Model / step: model FLOPs of the work the window did over the window
times the bf16 peak (``peaks.json``). Serving: each admitted clip's
encoder pass and cross K/V, and every decoder position of the requests
completed in the window. Fine-tune: 3 forwards a step, whatever the remat
policy (``lib/flops.py``)."""

from benchmark.lib import flops


def read(ctx):
    work = ctx.work
    if "train_label_lens" in work:
        total = sum(flops.train_step(ctx.cfg, work["batch"], n)
                    for n in work["train_label_lens"])
    else:
        p_len = len(ctx.cfg["deployment"]["prompt"])
        total = (flops.encoder_fwd(ctx.cfg) + flops.cross_kv(ctx.cfg)) * \
            sum(work.get("admitted", []))
        total += sum(flops.decode_positions(ctx.cfg,
                                            p_len - 1 + len(r["tokens"]))
                     for r in work.get("completed", []))
    if not total:
        return None
    return 100.0 * total / (ctx.window_s * ctx.peaks["bf16_flops"])
