"""Tracing and profiling utilities (counterpart of
``lpr_tpu/utils/observability.py``).

Reference analogues: FPS counters from wall-clock deltas
(``inference/run.py:262-266``), synchronized stage timers
(``yolov5/utils/torch_utils.py:101-105`` ``time_sync``), the per-layer
summary (``yolov5/models/yolo.py:260``).

- :func:`device_sync` — wait for the card that holds a result;
- :class:`FpsMeter` — a rolling frames-per-second estimate;
- :class:`StageTimer` — wall clock per stage, ended by a synchronize (the
  time a caller waits; device time is ``tools/_timing.event_ms``'s);
- :func:`profile_trace` — a ``torch.profiler`` trace into ``logdir``
  (TensorBoard's format), whose failure to stop raises;
- :func:`model_summary` — per-layer parameter counts of a built detector.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

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


class FpsMeter:
    """Rolling frames-per-second estimate (reference run.py:262-266)."""

    def __init__(self, alpha: float = 0.9):
        self.alpha = alpha
        self._fps: Optional[float] = None
        self._t: Optional[float] = None

    def tick(self, frames: int = 1) -> float:
        now = time.perf_counter()
        if self._t is not None:
            inst = frames / max(now - self._t, 1e-9)
            self._fps = (inst if self._fps is None
                         else self.alpha * self._fps + (1 - self.alpha) * inst)
        self._t = now
        return self._fps or 0.0


class StageTimer:
    """Accumulating per-stage wall timers, each ended by a synchronize on
    the stage's result."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, result_tree: Any = None):
        t0 = time.perf_counter()
        yield
        if result_tree is not None:
            device_sync(result_tree)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        rows = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            ms = 1000 * self.totals[k] / max(self.counts[k], 1)
            rows.append(f"{k:<24} {ms:8.2f} ms/call x{self.counts[k]}")
        return "\n".join(rows)


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
