"""A closed loop: ``clients`` threads, client c sending frame
``c mod distinct_frames`` and the next request as soon as the last is
answered."""

from __future__ import annotations

import threading
import time


def threads(run, route, mix, start, span_s, seed, rate_fps, stop,
            deadline_s):
    from lprbench.load import Request

    nf = int(mix["distinct_frames"])

    def client(cid: int) -> None:
        while not stop.is_set():
            fut = run.send(route, Request(cid % nf, time.perf_counter()))
            if fut is None:
                continue
            try:
                fut.result(deadline_s)
            except Exception:            # recorded on the request
                if not fut.done():
                    return

    return [threading.Thread(target=client, args=(c,), daemon=True)
            for c in range(int(mix["clients"]))]
