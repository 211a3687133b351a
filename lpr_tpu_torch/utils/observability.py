"""Tracing and profiling of the port (counterpart of
``lpr_tpu/utils/observability.py``).

The served path (``serve/server.py`` around ``pipeline/recognizer.py``)
measures itself at every layer boundary, in two tiers, on one clock: the
host's ``time.perf_counter_ns()``, onto which the card's stamps are
mapped (``kernels/stamp.py`` :func:`~lpr_tpu_torch.kernels.stamp.calibrate`).

**Counters** are always on and cost a few clock reads a batch and a bucket
increment a request.  Read them from ``server.stats``
(:class:`~lpr_tpu_torch.serve.server.ServerStats`), or take
``server.stats.counters()`` at two moments and subtract them with
:func:`difference` to get a window's:

- ``collect_s``, ``dispatch_s``, ``resolve_s``: the collector thread's time
  in its three calls; ``dispatch_phase_s`` and ``resolve_phase_s`` split
  the last two (``DISPATCH_PHASES``, ``RESOLVE_PHASES`` in ``server.py``);
- ``queue_wait``: a :class:`LogHistogram` of each request's wait from its
  enqueue to the start of its batch's dispatch (``quantile(95)``);
- ``stage_s``, ``step_device_s``, ``stamped_batches``: the device time of
  each stage of the step (``DEVICE_STAGES`` in ``recognizer.py``) and of
  the whole step, first stamp to last, summed over the batches whose
  stamps came back.  On a card, frozen or eager, the stamps are kernels
  on the step's stream that write the card's clock as it reaches them;
  only a recognizer on the CPU stamps with the host's clock;
- ``gc_pause_s``, ``gc_collections``: Python's garbage-collection pauses by
  generation while the server runs (any thread's);
- ``PlateRecognizer.graph_captures``: CUDA graphs captured (one a batch
  shape); ``clock_offset_ns`` and ``clock_uncertainty_ns``: the card
  clock's mapping, calibrated at each capture (or at the first eager
  step).

**Spans** are recorded only after ``server.tracer.enable()``
(:class:`Tracer`; ``disable()`` stops them) into a ring of fixed size that
drops the oldest when full (``tracer.dropped``).  ``tracer.spans()`` lists
them as :class:`Span` (name, start and end in ``perf_counter_ns``, the id
of their request or batch, their parent's name, their lane);
``tracer.chrome_trace(path)`` writes them as Chrome-trace JSON (open it in
``chrome://tracing`` or Perfetto).  What each span means:

- ``request`` (lane ``request``, id: the request's): from its enqueue to
  its result being set; child ``queue``: enqueue to its batch's dispatch;
- ``collect``, ``dispatch``, ``resolve`` (lane ``collector``, id: the
  batch's): the collector's three calls for a batch; ``dispatch``'s
  children ``staging`` (the wait for a pinned staging buffer and the
  gather into it), ``replay`` (the CUDA graph's replay; in the eager step,
  the stages' launches), ``clone`` (the outputs copied out of the graph's
  pool) and ``host copy start``; ``resolve``'s children ``copy wait``,
  ``host conversion``, ``assemble`` and ``futures`` (setting the results,
  which runs the callers' done-callbacks on the collector thread);
- ``step`` (lane ``device``, id: the batch's): the device step from its
  first stamp to its last, with one child a stage of ``DEVICE_STAGES``;
- ``gc`` (lane ``gc``, id: the generation): a collection of generation 1
  or 2.

Reference analogues: FPS counters from wall-clock deltas
(``inference/run.py:262-266``), synchronized stage timers
(``yolov5/utils/torch_utils.py:101-105`` ``time_sync``), the per-layer
summary (``yolov5/models/yolo.py:260``).

- :func:`device_sync` — wait for the card that holds a result;
- :class:`Tracer`, :class:`Span` — the span ring and its exporter;
- :class:`LogHistogram` — counts in fixed log buckets, 4 % wide;
- :func:`watch_gc` — a ``gc.callbacks`` hook timing each collection;
- :func:`difference` — a window's counters from two snapshots;
- :func:`profile_trace` — a ``torch.profiler`` trace into ``logdir``
  (TensorBoard's format), whose failure to stop raises;
- :func:`model_summary` — per-layer parameter counts of a built detector.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import tempfile
import threading
import time
from collections import defaultdict, deque
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Sequence)

import torch


def _first_cuda(tree: Any) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree if tree.device.type == "cuda" else None
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            t = _first_cuda(v)
            if t is not None:
                return t
    return None


def device_sync(tree: Any) -> None:
    """Wait for the card of the first CUDA tensor of ``tree`` (dicts,
    lists, tuples); nothing when it holds none (the CPU's results are
    ready when returned)."""
    t = _first_cuda(tree)
    if t is not None:
        torch.cuda.synchronize(t.device)


class Span(NamedTuple):
    """One recorded span: ``t0`` and ``t1`` in ``time.perf_counter_ns()``;
    ``id`` the request's or batch's (a collection's generation for
    ``gc``); ``parent`` the name of the span it nests in; ``lane`` where it
    ran (``collector``, ``device``, ``request``, ``gc``)."""

    name: str
    t0: int
    t1: int
    id: Optional[int] = None
    parent: Optional[str] = None
    lane: str = "collector"


class Tracer:
    """Spans in a ring of ``capacity``, recorded only between
    :meth:`enable` and :meth:`disable`; a full ring drops its oldest span
    for each new one and counts it in :attr:`dropped`."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self.enabled = False
        self.recorded = 0
        self._ring: "deque[Span]" = deque(maxlen=capacity)
        # reentrant: a collection inside a locked region (any allocation)
        # runs the gc hook, which records a span on the same thread
        self._lock = threading.RLock()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def record(self, name: str, t0: int, t1: int, id: Optional[int] = None,
               parent: Optional[str] = None, lane: str = "collector") -> None:
        """Keep a span (ns of ``perf_counter_ns``) while enabled."""
        if not self.enabled:
            return
        span = Span(name, int(t0), int(t1), id, parent, lane)
        with self._lock:
            self._ring.append(span)
            self.recorded += 1

    @property
    def dropped(self) -> int:
        """Spans the full ring has dropped."""
        return max(0, self.recorded - self.capacity)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def chrome_trace(self, path: Optional[str] = None) -> dict:
        """The spans as Chrome-trace JSON (written to ``path`` where given):
        one thread a lane, requests as async events by id, times in us."""
        lanes = ("collector", "device", "gc", "request")
        events = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": i,
                   "args": {"name": lane}} for i, lane in enumerate(lanes)]
        for s in self.spans():
            tid = lanes.index(s.lane) if s.lane in lanes else len(lanes)
            ev = {"name": s.name, "pid": 0, "tid": tid, "ts": s.t0 / 1e3,
                  "args": {"id": s.id, "parent": s.parent}}
            if s.lane == "request":
                events.append(dict(ev, ph="b", cat="request", id=s.id))
                events.append(dict(ev, ph="e", cat="request", id=s.id,
                                   ts=s.t1 / 1e3))
            else:
                events.append(dict(ev, ph="X", dur=(s.t1 - s.t0) / 1e3))
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace


class LogHistogram:
    """Counts of positive values (seconds) in fixed log buckets: bucket 0
    below ``LO``, bucket k in [LO r^(k-1), LO r^k) for the ratio r =
    ``RATIO`` (4 % wide), the last at or above ``HI``.  The buckets never
    move, so a window's counts are the difference of two snapshots of
    :attr:`counts`."""

    LO, HI, RATIO = 1e-6, 1e3, 1.04

    def __init__(self):
        self._log_r = math.log(self.RATIO)
        self.n = int(math.ceil(math.log(self.HI / self.LO) / self._log_r))
        self.counts = [0] * (self.n + 2)

    def index(self, x: float) -> int:
        if x < self.LO:
            return 0
        return min(1 + int(math.log(x / self.LO) / self._log_r), self.n + 1)

    def add(self, x: float) -> None:
        self.counts[self.index(x)] += 1

    def bounds(self, i: int):
        """[low, high) of bucket ``i``."""
        if i == 0:
            return 0.0, self.LO
        if i == self.n + 1:
            return self.LO * self.RATIO ** self.n, math.inf
        return self.LO * self.RATIO ** (i - 1), self.LO * self.RATIO ** i

    def quantile(self, q: float, counts: Optional[Sequence[int]] = None
                 ) -> Optional[float]:
        """The ``q``-th percentile (nearest rank) of ``counts`` (default:
        all so far), as its bucket's geometric middle; None when empty."""
        counts = self.counts if counts is None else counts
        total = sum(counts)
        if total <= 0:
            return None
        rank = max(1, math.ceil(q / 100.0 * total))
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                lo, hi = self.bounds(i)
                return lo if math.isinf(hi) else (
                    hi if lo == 0 else math.sqrt(lo * hi))
        return None


def watch_gc(on_pause: Callable[[int, int, int], None]
             ) -> Callable[[], None]:
    """Add a ``gc.callbacks`` hook that calls ``on_pause(generation, t0,
    t1)`` (``perf_counter_ns``) after each collection, on the thread that
    collected; returns the function that removes it."""
    start = [0]

    def hook(phase: str, info: dict) -> None:
        if phase == "start":
            start[0] = time.perf_counter_ns()
        else:
            on_pause(int(info["generation"]), start[0],
                     time.perf_counter_ns())

    gc.callbacks.append(hook)

    def remove() -> None:
        if hook in gc.callbacks:
            gc.callbacks.remove(hook)

    return remove


def difference(a: Any, b: Any) -> Any:
    """``b - a`` of two snapshots of the same counters (numbers, lists of
    numbers and dicts of them, as ``ServerStats.counters()`` gives)."""
    if isinstance(a, dict):
        return {k: difference(a.get(k, 0), v) for k, v in b.items()}
    if isinstance(a, (list, tuple)):
        return [y - x for x, y in zip(a, b)]
    return b - a


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None) -> Iterator[str]:
    """A ``torch.profiler`` trace of the block (the host, and the card
    where there is one), written into ``logdir`` (default
    ``lpr_tpu_torch_trace`` in the temporary directory) as TensorBoard's
    profiler plugin reads it.  A failure to stop the profiler or to write
    the trace raises."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "lpr_tpu_torch_trace")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


def model_summary(model) -> str:
    """Per-layer parameter counts of a built
    :class:`~lpr_tpu_torch.models.yolo.YoloModel`, as the JAX summary
    counts them: the unfolded weights of every layer (batch norm's four
    vectors included) from :func:`~lpr_tpu_torch.models.yolo_train
    .yolo_init`."""
    from lpr_tpu_torch.models.yolo_train import yolo_init

    counts: Dict[str, int] = defaultdict(int)
    for k, v in yolo_init(model).items():
        counts[k.split("/", 1)[0]] += int(v.size)
    rows = [f"{'idx':>3} {'from':>10} {'params':>10}  type"]
    for layer in model.layers:
        rows.append(f"{layer.i:>3} {str(layer.f):>10} "
                    f"{counts[str(layer.i)]:>10}  {type(layer).__name__}")
    rows.append(f"total params: {sum(counts.values())}")
    return "\n".join(rows)
