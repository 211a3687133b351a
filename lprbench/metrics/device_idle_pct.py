"""The share of the traced window in which no kernel, copy or memset ran
on the card (``torch.profiler``, CUPTI), in % (layer: device).  Serves
``device_idle_pct.tput`` and ``device_idle_pct.lat``."""


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.window_s <= 0 or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
