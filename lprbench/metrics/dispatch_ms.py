"""The collector's host time to gather a batch and launch its step
(``ServerStats.dispatch_s``), ms a batch over the window (layer: server).
Serves ``dispatch_ms.tput`` and ``dispatch_ms.lat``."""


def read(ctx):
    s = ctx.window_stats
    if not s["batches"]:
        return None
    return 1e3 * s["dispatch_s"] / s["batches"]
