"""The load generator: drives a traffic mix (``lprbench/traffic/<name>.json``)
against the server.  The mix names its two parts, each a file found by
name, so that a new kind of traffic is a new file:

- ``"driver"``: ``lprbench/drivers/<driver>.py``, the loop that decides when
  each request is sent (``closed``: clients that wait for their answers;
  ``open``: periodic cameras at the cell's rate);
- ``"route"``: ``lprbench/routes/<route>.py``, how a request reaches the
  server (``host``: ``InferenceServer.submit`` with a host frame).

Each request is timed from when it was due (the driver's schedule; a
closed client's send) to the moment its answer was set, so a stall counts
against every request behind it.  The window is ``[ramp_s, ramp_s +
seconds)`` after the first send.
"""

from __future__ import annotations

import dataclasses
import importlib
import threading
import time
from typing import Any, List, Optional


@dataclasses.dataclass
class Request:
    frame: int
    due: float
    sent: float = float("nan")
    done: float = float("nan")
    result: Any = None
    error: Optional[BaseException] = None

    def answered(self) -> bool:
        return self.done == self.done and self.error is None


class Run:
    """One run of a mix: ``requests`` and the window ``(t0, t1)`` on the
    host clock."""

    def __init__(self):
        self.requests: List[Request] = []
        self.t0 = self.t1 = 0.0
        self.pending: list = []
        self.lock = threading.Lock()

    def in_window(self, when: str) -> List[Request]:
        return [r for r in self.requests
                if self.t0 <= getattr(r, when) < self.t1]

    def send(self, route, req: Request):
        """Send ``req`` through ``route`` now; its answer (or the refusal,
        counted as failed) is recorded on it.  Returns the future, or None
        where the route refused."""
        req.sent = time.perf_counter()
        with self.lock:
            self.requests.append(req)
        try:
            fut = route.submit(req.frame)
        except Exception as e:          # refused: counted as failed
            req.error, req.done = e, time.perf_counter()
            return None

        def fin(f):
            req.done = time.perf_counter()
            if f.exception() is not None:
                req.error = f.exception()
            else:
                req.result = f.result()
        with self.lock:
            self.pending.append(fut)
        fut.add_done_callback(fin)
        return fut


def _part(kind: str, name: str):
    return importlib.import_module(f"lprbench.{kind}.{name}")


def route(mix: dict, server, frames):
    """The mix's route to ``server`` with the run's frames."""
    return _part("routes", mix["route"]).Route(server, frames)


def drive(route, mix: dict, seconds: float, seed: int,
          rate_fps: Optional[float] = None, during=None,
          deadline_s: float = 60.0) -> Run:
    """Drive ``route`` with the mix's driver for ``ramp_s + seconds`` from
    side threads, then wait up to ``deadline_s`` for every request sent.
    ``during(t0, t1)``, when given, runs on the calling thread inside the
    window (the server's counters read at its ends)."""
    run = Run()
    ramp = float(mix.get("ramp_s", 0.0))
    stop = threading.Event()
    start = time.perf_counter()
    run.t0, run.t1 = start + ramp, start + ramp + seconds
    threads = _part("drivers", mix["driver"]).threads(
        run, route, mix, start, ramp + seconds, seed, rate_fps, stop,
        deadline_s)
    for t in threads:
        t.start()
    if during is not None:
        during(run.t0, run.t1)
    time.sleep(max(0.0, run.t1 - time.perf_counter()))
    stop.set()
    for t in threads:
        t.join(deadline_s)
    end = time.perf_counter() + deadline_s
    for f in list(run.pending):
        try:
            f.result(max(0.0, end - time.perf_counter()))
        except Exception:                # recorded by the callback
            pass
    return run
