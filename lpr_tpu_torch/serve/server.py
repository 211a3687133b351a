"""In-process dynamic-batching inference server (counterpart of
``lpr_tpu/serve/server.py``).

Requests enqueue single frames; a collector thread forms batches up to
``max_batch`` within ``max_delay_ms`` (Triton dynamic-batching semantics),
pads to ``max_batch`` so every step sees one batch shape, runs the
recognizer's device step and resolves per-request futures.  The step is
the recognizer's ``step_raw``: with ``freeze_params`` (the default) one
CUDA graph replay, captured at the first batch (one shape, so one graph),
whose outputs are copies that the next replay leaves alone; with
``packed_input`` its host letterbox runs here in the collector, before the
batch goes to the device (as the JAX server's step_raw packs).  The step
of batch N+1 is launched before batch N's results are copied to the host
and assembled (a one-deep pipeline).

The collector is a daemon thread.  :meth:`InferenceServer.stop` joins it
with a timeout and fails every request still queued, so no future is left
unresolved.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from lpr_tpu_torch.pipeline.recognizer import to_host


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8          # step batch size (pad to this)
    max_delay_ms: float = 5.0   # dynamic batching window
    queue_size: int = 256
    # Optional up-front frame shape lock (H, W); otherwise the first
    # submitted frame fixes the served shape and mismatches are rejected
    # at submit() time.
    frame_hw: Optional[tuple] = None
    # Return the SR plate-crop images in each result dict; False never
    # copies them off the device.
    return_sr: bool = True


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    frames_padded: int = 0
    total_latency_s: float = 0.0
    latencies_s: list = dataclasses.field(default_factory=list)
    max_latencies: int = 100_000
    started_s: float = dataclasses.field(default_factory=time.perf_counter)

    def record(self, latency_s: float) -> None:
        self.requests += 1
        self.total_latency_s += latency_s
        if len(self.latencies_s) < self.max_latencies:
            self.latencies_s.append(latency_s)

    @property
    def mean_batch(self) -> float:
        return self.requests / max(self.batches, 1)

    @property
    def mean_latency_ms(self) -> float:
        return 1000.0 * self.total_latency_s / max(self.requests, 1)

    def latency_ms(self, pct: float) -> float:
        """Latency percentile (e.g. 50, 99) over recorded requests."""
        if not self.latencies_s:
            return 0.0
        xs = sorted(self.latencies_s)
        i = min(int(round(pct / 100.0 * (len(xs) - 1))), len(xs) - 1)
        return 1000.0 * xs[i]

    @property
    def throughput_fps(self) -> float:
        dt = time.perf_counter() - self.started_s
        return self.requests / dt if dt > 0 else 0.0

    def summary(self) -> dict:
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_batch": round(self.mean_batch, 2),
            "frames_padded": self.frames_padded,
            "throughput_fps": round(self.throughput_fps, 2),
            "latency_ms_mean": round(self.mean_latency_ms, 2),
            "latency_ms_p50": round(self.latency_ms(50), 2),
            "latency_ms_p99": round(self.latency_ms(99), 2),
        }


class InferenceServer:
    """Dynamic-batching dispatch loop over a
    :class:`~lpr_tpu_torch.pipeline.recognizer.PlateRecognizer`."""

    def __init__(self, recognizer, cfg: ServeConfig = ServeConfig()):
        self.rec = recognizer
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(cfg.queue_size)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = ServerStats()
        self._shape_lock = threading.Lock()
        self._frame_shape: Optional[tuple] = (
            (*cfg.frame_hw, 3) if cfg.frame_hw is not None else None)

    def start(self) -> "InferenceServer":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lpr-collector")
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the collector (joined with ``timeout``) and fail every
        request that is still queued."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(f"collector thread still running after "
                                   f"{timeout} s")
        self._drain()

    def _drain(self) -> None:
        """Fail every queued request (after the collector has stopped)."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            self._fail([item], RuntimeError("server stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------------
    def submit(self, frame: np.ndarray) -> Future:
        """frame: (H, W, 3) uint8 RGB -> Future[List[plate dict]].  The first
        accepted frame (or ``ServeConfig.frame_hw``) locks the served shape;
        a mismatch raises here instead of poisoning a batch."""
        if self._stop.is_set():
            raise RuntimeError("server stopped")
        frame = np.asarray(frame)
        if frame.ndim != 3 or frame.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) RGB frame, got {frame.shape}")
        if frame.dtype != np.uint8:
            raise ValueError(f"expected uint8 frame, got {frame.dtype}")
        with self._shape_lock:
            if self._frame_shape is None:
                self._frame_shape = frame.shape
            elif frame.shape != self._frame_shape:
                raise ValueError(
                    f"frame shape {frame.shape} does not match the served "
                    f"shape {self._frame_shape}")
        fut: Future = Future()
        self._q.put((frame, fut, time.perf_counter()))
        if self._stop.is_set():  # stop() may have drained before the put
            self._drain()
        return fut

    def infer(self, frame: np.ndarray, timeout: Optional[float] = None):
        return self.submit(frame).result(timeout)

    def submit_many(self, frames: np.ndarray) -> List[Future]:
        """(B, H, W, 3) uint8 -> one future per frame, through the same
        dynamic-batching queue."""
        return [self.submit(f) for f in np.asarray(frames)]

    def infer_many(self, frames: np.ndarray, timeout: Optional[float] = None):
        return [f.result(timeout) for f in self.submit_many(frames)]

    # ------------------------------------------------------------------
    def _collect(self, block: bool) -> List:
        """One item (optionally waiting), then fill the batch within the
        delay window."""
        try:
            first = self._q.get(timeout=0.1) if block else self._q.get_nowait()
        except queue.Empty:
            return []
        items = [first]
        deadline = time.perf_counter() + self.cfg.max_delay_ms / 1000.0
        while len(items) < self.cfg.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    @staticmethod
    def _fail(items, err: BaseException) -> None:
        for _, fut, _ in items:
            if not fut.done():
                fut.set_exception(err)

    def _dispatch(self, items):
        """Pad the batch and launch its device step.  Returns the pending
        (out, items, n, pad), or None after failing the futures."""
        n = len(items)
        pad = self.cfg.max_batch - n
        try:
            frames = [it[0] for it in items]
            out = self.rec.step_raw(np.stack(frames + [frames[-1]] * pad))
        except Exception as e:  # the collector must keep serving
            self._fail(items, e)
            return None
        return out, items, n, pad

    def _resolve(self, pending) -> None:
        """Copy a launched batch's outputs to the host and resolve its
        futures."""
        out, items, n, pad = pending
        try:
            if not self.cfg.return_sr:
                out = {k: v for k, v in out.items() if k != "sr"}
            results = self.rec.assemble(to_host(out))
        except Exception as e:  # the collector must keep serving
            self._fail(items, e)
            return
        now = time.perf_counter()
        self.stats.batches += 1
        self.stats.frames_padded += pad
        for (_, fut, t0), res in zip(items, results[:n]):
            self.stats.record(now - t0)
            fut.set_result(res)

    def _loop(self) -> None:
        pending = None
        while not self._stop.is_set():
            items = self._collect(block=pending is None)
            nxt = self._dispatch(items) if items else None
            if pending is not None:
                self._resolve(pending)
            pending = nxt
        if pending is not None:
            self._resolve(pending)
