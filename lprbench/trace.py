"""The trace of a ``--trace 1`` run: ``torch.profiler`` (CPU and CUDA
activity, CUPTI), started from the main thread once the untraced window
has been answered, while the server is idle, and stopped after the server
has stopped, so that no profiler start or stop overlaps the load (an H100
run hung once when one did, and a process's first CUPTI session, started
under the open loop, recorded no device event at all); reduced over the
traced window, between two clock marks the main thread records at its
start and end, to what the per-layer readers and the breakdown need.  The
profiler costs the host time on every launch, so the run reads the host's
metrics from its untraced window and only the device's from this one.
Nothing is written to disk.

- the device's busy time: the union of the kernel, copy and memset
  intervals between the marks, and the window's length between them;
- each device operation's summed time and count;
- the idle gaps (no device operation running), each named by the server's
  collector phase (``collect``, ``dispatch``, ``resolve``: host spans the
  harness records around those calls in the traced run) at the gap's
  middle, the longest first.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

MARK = "lprbench.clock_mark"


class Slice:
    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.ops: Dict[str, Tuple[float, int]] = {}
        self.gaps: List[Tuple[str, float]] = []
        self.t_start = self.t_end = 0.0       # host clock
        self.device_events = self.device_events_inside = 0

    def op_time(self, substring: str) -> Tuple[float, int]:
        """Summed seconds and count of the device operations whose name
        holds ``substring``."""
        s, n = 0.0, 0
        for name, (t, k) in self.ops.items():
            if substring in name:
                s, n = s + t, n + k
        return s, n


class Tracer:
    """The profiler of a traced run: :meth:`start` with the server idle,
    :meth:`mark`
    at the window's start and end (main thread), :meth:`stop` once the
    server has stopped, then :meth:`reduce`."""

    def __init__(self, spans):
        from torch.profiler import ProfilerActivity, profile

        self.spans = spans
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.out = Slice()

    def start(self) -> None:
        self.prof.start()

    def mark(self) -> None:
        """A clock mark: the window's start (first call) or end."""
        from torch.autograd.profiler import record_function

        with record_function(MARK):
            pass
        if self.out.t_start == 0.0:
            self.out.t_start = time.perf_counter()
            self.spans.on = True
        else:
            self.spans.on = False
            self.out.t_end = time.perf_counter()

    def stop(self) -> Slice:
        self.prof.stop()
        self.out.window_s = self.out.t_end - self.out.t_start
        reduce(self.prof, self.out, self.spans.items)
        return self.out


def reduce(prof, out: Slice, spans) -> None:
    """Busy time, operations and named idle gaps of the traced window: the
    device intervals between the two clock marks (CPU events in the
    profiler's own clock), the host spans placed by the first mark."""
    evs = prof.profiler.kineto_results.events()
    dev, marks = [], []
    for e in evs:
        kind = str(e.device_type())
        s = e.start_ns()
        if e.name() == MARK and kind.endswith("CPU"):
            marks.append(s)
        elif kind.endswith("CUDA") and e.name() != MARK:
            dev.append((s, s + e.duration_ns(), e.name()))
    if len(marks) != 2:
        raise RuntimeError(f"the profiler kept {len(marks)} of 2 marks")
    lo, hi = sorted(marks)
    out.device_events = len(dev)
    inside = [(max(s, lo), min(e, hi), n) for s, e, n in dev
              if e > lo and s < hi]
    out.device_events_inside = len(inside)
    if not inside:
        return
    dev = inside
    for s, e, name in dev:
        t, k = out.ops.get(name, (0.0, 0))
        out.ops[name] = (t + (e - s) / 1e9, k + 1)
    dev.sort()
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    if cur_s > lo:
        gaps.append((lo, cur_s))
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    out.busy_s = busy / 1e9
    out.window_s = (hi - lo) / 1e9
    gaps.sort(key=lambda g: g[0] - g[1])          # longest first
    offset = lo - out.t_start * 1e9
    host = [(s * 1e9 + offset, e * 1e9 + offset, n) for n, s, e in spans]
    for gs, ge in gaps[:10]:
        mid = 0.5 * (gs + ge)
        inner = [n for s, e, n in host if s <= mid < e]
        out.gaps.append((f"collector {inner[0]}" if inner
                         else "collector between calls", (ge - gs) / 1e9))


class Spans:
    """Host spans of the server's collector thread, around its three
    calls (``_collect``, ``_dispatch``, ``_resolve``), recorded while
    ``on``."""

    def __init__(self):
        self.on = False
        self.items: List[Tuple[str, float, float]] = []

    def wrap(self, server) -> None:
        for name in ("_collect", "_dispatch", "_resolve"):
            setattr(server, name, self._timed(name[1:],
                                              getattr(server, name)))

    def _timed(self, label, fn):
        def call(*args, **kw):
            if not self.on:
                return fn(*args, **kw)
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.items.append((label, t, time.perf_counter()))
        return call


def breakdown(out: Slice) -> dict:
    ops = sorted(out.ops.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[n, t] for n, (t, _) in ops],
            "idle_gaps": [[n, t] for n, t in out.gaps]}
