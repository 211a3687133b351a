"""How late the generator sent the window's requests against their due
times: the 95th percentile, in ms (layer: load generator)."""

import numpy as np


def read(ctx):
    lags = [r.sent - r.due for r in ctx.run.in_window("due")]
    if not lags:
        return None
    return 1e3 * float(np.percentile(lags, 95))
