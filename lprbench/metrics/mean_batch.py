"""Frames a served step carried, not counting its padding: requests over
batches that the server resolved in the window (``ServerStats``; layer:
server).  Serves ``mean_batch.tput`` and ``mean_batch.lat``."""


def read(ctx):
    s = ctx.window_stats
    if not s["batches"]:
        return None
    return s["requests"] / s["batches"]
