"""The served step's share of the card's bf16 peak: the model FLOPs of a
served frame (``lprbench/work/model_flops.py``, from the configuration)
times the frames answered in the window, over its length times the peak,
in % (layer: step).  Padded frames are not counted."""

from lprbench.work.model_flops import per_frame


def read(ctx):
    run = ctx.run
    n = sum(1 for r in run.requests
            if r.answered() and run.t0 <= r.done < run.t1)
    if not n:
        return None
    flops = per_frame(ctx.cfg)["total"] * n
    return 100.0 * flops / ((run.t1 - run.t0) * ctx.peaks["bf16_flops"])
