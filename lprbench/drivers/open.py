"""An open loop: ``cameras`` periodic sources at the cell's total
``rate_fps``.  Camera i sends frame ``i mod distinct_frames`` every
``cameras / rate_fps`` seconds, from a phase drawn from the seed, each
send moved by a uniform jitter of +-``jitter`` of the period.  One thread
sends every request at its due time, whether or not earlier ones are
answered."""

from __future__ import annotations

import threading
import time
from typing import List

import numpy as np


def schedule(mix: dict, rate_fps: float, span_s: float, seed: int
             ) -> List[tuple]:
    """The sends over ``span_s`` seconds: sorted (due offset, camera)
    pairs, drawn from ``seed``."""
    rng = np.random.RandomState(seed % 2**32)
    n = int(mix["cameras"])
    period = n / float(rate_fps)
    jit = float(mix.get("jitter", 0.0))
    sends = []
    for cam in range(n):
        phase = rng.uniform(0.0, period)
        k = 0
        while True:
            t = phase + k * period
            if t >= span_s:
                break
            k += 1
            d = t + rng.uniform(-jit, jit) * period
            if 0.0 <= d < span_s:
                sends.append((d, cam))
    sends.sort()
    return sends


def threads(run, route, mix, start, span_s, seed, rate_fps, stop,
            deadline_s):
    from lprbench.load import Request

    nf = int(mix["distinct_frames"])

    def cameras() -> None:
        for off, cam in schedule(mix, rate_fps, span_s, seed):
            due = start + off
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            run.send(route, Request(cam % nf, due))

    return [threading.Thread(target=cameras, daemon=True)]
