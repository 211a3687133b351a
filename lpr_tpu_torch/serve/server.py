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
of batch N+1 is launched before batch N's results are assembled (a
one-deep pipeline); batch N's outputs start their copy to the host as soon
as its step is launched, ahead of batch N+1's step on the stream.

Files and encoded bytes (:meth:`InferenceServer.submit_path`,
``submit_paths``, ``submit_bytes``) are decoded and letterboxed to the
served shape on a pool of ``decode_workers`` threads by the port's C host
decode (:mod:`lpr_tpu_torch.native`), which releases the interpreter lock,
so decoding overlaps the device step.  A device-resident frame pool
(:meth:`InferenceServer.preload`, then ``submit_ref``/``infer_ref`` by
index) keeps the frames on the card: a batch gathers its frames there and
only the indices leave the host.

The collector is a daemon thread.  :meth:`InferenceServer.stop` shuts the
decode pool down, joins the collector with a timeout and fails every
request still queued, so no future is left unresolved.

The server measures itself (``utils/observability.py`` says how to read
it): counters in ``stats`` (:class:`ServerStats`) always, and spans in
``tracer`` once ``tracer.enable()`` is called.  Each request gets an id at
its enqueue and each batch one at its dispatch; a request's queue wait,
the sub-phases of ``_dispatch`` and ``_resolve``, each device stage's time
from the step's stamps, and the garbage collector's pauses while the
server runs are summed into ``stats``.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from lpr_tpu_torch.pipeline.recognizer import (DEVICE_STAGES, start_to_host,
                                               stamp_times)
from lpr_tpu_torch.utils.observability import LogHistogram, Tracer, watch_gc

# The sub-phases of a batch's dispatch and resolve (ServerStats
# dispatch_phase_s / resolve_phase_s; the span children of "dispatch" and
# "resolve").  A capture replaces "staging" on the first step of a shape.
DISPATCH_PHASES = ("staging", "replay", "clone", "host copy start")
RESOLVE_PHASES = ("copy wait", "host conversion", "assemble", "futures")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8          # step batch size (pad to this)
    max_delay_ms: float = 5.0   # dynamic batching window
    queue_size: int = 256
    # Optional up-front frame shape lock (H, W); otherwise the first
    # submitted frame fixes the served shape and mismatches are rejected
    # at submit() time.
    frame_hw: Optional[tuple] = None
    # Host decode threads of submit_path/submit_paths/submit_bytes (JPEG/PNG
    # -> letterboxed uint8 through the port's C host decode, which runs
    # without the interpreter lock, so the threads scale).
    decode_workers: int = 8
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
    # The collector thread's time (s), summed over its loop: waiting for
    # and gathering requests (_collect), assembling a batch and launching
    # its step (_dispatch), and waiting for, copying and assembling a
    # launched batch's outputs (_resolve).  Read by bench_serving's
    # collector_ms; not part of summary(), which matches lpr_tpu's.
    collect_s: float = 0.0
    dispatch_s: float = 0.0
    resolve_s: float = 0.0
    # Their sub-phases (s): DISPATCH_PHASES (and "capture"), RESOLVE_PHASES
    dispatch_phase_s: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(DISPATCH_PHASES, 0.0))
    resolve_phase_s: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(RESOLVE_PHASES, 0.0))
    # Each request's wait from its enqueue to its batch's dispatch (s)
    queue_wait: LogHistogram = dataclasses.field(default_factory=LogHistogram)
    # Device time (s) of each DEVICE_STAGES stage and of the whole step
    # (first stamp to last), summed over the batches whose stamps came back
    stage_s: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(DEVICE_STAGES, 0.0))
    step_device_s: float = 0.0
    stamped_batches: int = 0
    # Garbage-collection pauses (s) and collections by generation
    gc_pause_s: Dict[int, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys((0, 1, 2), 0.0))
    gc_collections: Dict[int, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys((0, 1, 2), 0))

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

    def counters(self) -> dict:
        """A snapshot of every counter (numbers, dicts of them and the
        queue wait's bucket counts); two snapshots'
        :func:`~lpr_tpu_torch.utils.observability.difference` is a
        window's."""
        return {
            "requests": self.requests, "batches": self.batches,
            "frames_padded": self.frames_padded,
            "collect_s": self.collect_s, "dispatch_s": self.dispatch_s,
            "resolve_s": self.resolve_s,
            "dispatch_phase_s": dict(self.dispatch_phase_s),
            "resolve_phase_s": dict(self.resolve_phase_s),
            "queue_wait": list(self.queue_wait.counts),
            "stage_s": dict(self.stage_s),
            "step_device_s": self.step_device_s,
            "stamped_batches": self.stamped_batches,
            "gc_pause_s": dict(self.gc_pause_s),
            "gc_collections": dict(self.gc_collections),
        }

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


@dataclasses.dataclass
class _Batch:
    """A dispatched batch: its id, its queue items (frame, future, enqueue
    time in ``perf_counter_ns``, request id), how many are real and how
    many pad it, the fetch of its outputs (:func:`start_to_host`) and the
    start of its dispatch (``perf_counter_ns``)."""

    id: int
    items: list
    n: int
    pad: int
    fetch: Callable
    t_dispatch: int


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
        self._decoder = None  # the decode thread pool, made at first use
        self._pool = None     # the device-resident frame pool (preload)
        # spans, recorded once tracer.enable() is called
        self.tracer = Tracer()
        self._request_ids = itertools.count()
        self._batch_ids = itertools.count()
        self._unwatch_gc: Optional[Callable[[], None]] = None

    def start(self) -> "InferenceServer":
        self._unwatch_gc = watch_gc(self._on_gc)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lpr-collector")
        self._thread.start()
        return self

    def _on_gc(self, generation: int, t0: int, t1: int) -> None:
        """A collection's pause, on whichever thread collected: summed by
        generation; with spans on, a ``gc`` span for generations 1 and
        2."""
        st = self.stats
        st.gc_pause_s[generation] += (t1 - t0) / 1e9
        st.gc_collections[generation] += 1
        if generation >= 1:
            self.tracer.record("gc", t0, t1, generation, lane="gc")

    def stop(self, timeout: float = 30.0) -> None:
        """Shut the decode pool down (its queued work still submits), stop
        the collector (joined with ``timeout``) and fail every request that
        is still queued."""
        if self._decoder is not None:
            self._decoder.shutdown(wait=True)
            self._decoder = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(f"collector thread still running after "
                                   f"{timeout} s")
        if self._unwatch_gc is not None:
            self._unwatch_gc()
            self._unwatch_gc = None
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
        if self._pool is not None:
            raise ValueError("the server is in device-pool (ref) mode after "
                             "preload(); use submit_ref(index)")
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
        return self._enqueue(frame)

    def _enqueue(self, item) -> Future:
        fut: Future = Future()
        self._q.put((item, fut, time.perf_counter_ns(),
                     next(self._request_ids)))
        if self._stop.is_set():  # stop() may have drained before the put
            self._drain()
        return fut

    def infer(self, frame: np.ndarray, timeout: Optional[float] = None):
        return self.submit(frame).result(timeout)

    # -- file/bytes ingestion (the port's C host decode) -----------------
    def _decode_pool(self):
        if self._decoder is None:
            from concurrent.futures import ThreadPoolExecutor

            self._decoder = ThreadPoolExecutor(
                max_workers=self.cfg.decode_workers,
                thread_name_prefix="lpr-decode")
        return self._decoder

    def _served_hw(self) -> tuple:
        """The served (H, W) for decoded images; also builds the host
        decode library here, so a machine without it (no libjpeg/libpng
        headers) raises in the caller, with g++'s message."""
        from lpr_tpu_torch import native

        with self._shape_lock:
            if self._frame_shape is None:
                raise ValueError(
                    "submit_path/submit_bytes need a fixed frame shape: set "
                    "ServeConfig.frame_hw (encoded images are letterboxed "
                    "to it on the host)")
            hw = self._frame_shape[:2]
        native.library("host_decode")
        return hw

    @staticmethod
    def _forward(inner: Future, outer: Future) -> None:
        """Resolve ``outer`` with ``inner``'s result or exception."""
        def fwd(f):
            if outer.done():
                return
            err = f.exception()
            if err is not None:
                outer.set_exception(err)
            else:
                outer.set_result(f.result())

        inner.add_done_callback(fwd)

    def _chain(self, outer: Future, work) -> Future:
        """Run ``work`` (decode, then submit) on the decode pool and forward
        the future it returns, or its exception, to ``outer``."""
        def run():
            try:
                inner = work()
            except Exception as e:  # the future carries it, not the pool
                if not outer.done():
                    outer.set_exception(e)
                return
            self._forward(inner, outer)

        self._decode_pool().submit(run)
        return outer

    def submit_path(self, path: str) -> Future:
        """Image file (JPEG/PNG) -> Future[List[plate dict]].  Decode and
        letterbox to the served shape (the native ``letterbox_into``'s
        geometry) run on the decode pool, overlapping the device step."""
        from lpr_tpu_torch import native

        hw = self._served_hw()
        return self._chain(Future(), lambda: self.submit(
            native.load_letterbox_batch([path], hw)[0]))

    def submit_paths(self, paths: List[str]) -> List[Future]:
        """Batch file ingestion: one native decode call (its own threads)
        per ``max_batch`` chunk on the decode pool, then each frame enters
        the dynamic-batching queue."""
        from lpr_tpu_torch import native

        hw = self._served_hw()
        outers = [Future() for _ in paths]

        def work_chunk(chunk_paths, chunk_outers):
            try:
                frames = native.load_letterbox_batch(list(chunk_paths), hw)
            except Exception as e:  # the futures carry it, not the pool
                self._fail([(None, o) for o in chunk_outers], e)
                return
            for frame, outer in zip(frames, chunk_outers):
                try:
                    inner = self.submit(frame)
                except Exception as e:  # the future carries it
                    self._fail([(None, outer)], e)
                    continue
                self._forward(inner, outer)

        chunk = max(1, self.cfg.max_batch)
        for s in range(0, len(paths), chunk):
            self._decode_pool().submit(
                work_chunk, paths[s:s + chunk], outers[s:s + chunk])
        return outers

    def submit_bytes(self, data: bytes) -> Future:
        """Encoded image bytes (JPEG/PNG) -> Future[List[plate dict]].  An
        image of another shape than the served one is resized with Pillow's
        bilinear resample (the port's C copy,
        :func:`lpr_tpu_torch.native.resize_pil_bilinear`) to fit, centred
        on a black canvas, as the JAX server does; bytes that do not decode
        fail the future."""
        from lpr_tpu_torch import native

        oh, ow = self._served_hw()

        def work():
            img = native.decode_image(data)
            if img is None:
                raise ValueError("undecodable image bytes")
            if img.shape[:2] != (oh, ow):
                h, w = img.shape[:2]
                r = min(oh / h, ow / w)
                nh, nw = max(int(round(h * r)), 1), max(int(round(w * r)), 1)
                canvas = np.zeros((oh, ow, 3), np.uint8)
                t, l = (oh - nh) // 2, (ow - nw) // 2
                canvas[t:t + nh, l:l + nw] = native.resize_pil_bilinear(
                    img, (nh, nw))
                img = canvas
            return self.submit(img)

        return self._chain(Future(), work)

    # -- device-resident frame pool --------------------------------------
    def preload(self, frames: np.ndarray) -> int:
        """Put a frame pool (N, H, W, 3) uint8 on the recognizer's device
        once; clients then name frames by index (:meth:`submit_ref`), so a
        batch gathers its frames on the device and only the indices leave
        the host.  With ``packed_input`` the pool also holds its frames'
        letterbox, made once here.  Needs the frozen step
        (``PipelineConfig.freeze_params``, the default).  After it the
        server is in ref mode: :meth:`submit` raises.  Returns the pool
        size."""
        frames = np.ascontiguousarray(np.asarray(frames, np.uint8))
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"expected (N, H, W, 3) pool, got {frames.shape}")
        if not getattr(getattr(self.rec, "cfg", None), "freeze_params",
                       False):
            raise ValueError("preload() requires the frozen step "
                             "(PipelineConfig.freeze_params, the default)")
        with self._shape_lock:
            if self._frame_shape is None:
                self._frame_shape = frames.shape[1:]
            elif frames.shape[1:] != self._frame_shape:
                raise ValueError(
                    f"pool frame shape {frames.shape[1:]} does not match the "
                    f"served shape {self._frame_shape}")
        dev = self.rec.device
        pool = {"frames": torch.from_numpy(frames).to(dev)}
        if self.rec.cfg.packed_input:
            pool["packed"] = torch.from_numpy(
                self.rec.host_letterbox(frames)).to(dev)
        self._pool = pool
        return frames.shape[0]

    def submit_ref(self, index: int) -> Future:
        """Pool index -> Future[List[plate dict]].  Needs :meth:`preload`."""
        if self._stop.is_set():
            raise RuntimeError("server stopped")
        if self._pool is None:
            raise ValueError("submit_ref requires preload() first")
        n = int(self._pool["frames"].shape[0])
        index = int(index)
        if not 0 <= index < n:
            raise IndexError(f"pool index {index} out of range [0, {n})")
        return self._enqueue(index)

    def infer_ref(self, index: int, timeout: Optional[float] = None):
        return self.submit_ref(index).result(timeout)

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
        for it in items:
            if not it[1].done():
                it[1].set_exception(err)

    def _dispatch(self, items) -> Optional[_Batch]:
        """Pad the batch, launch its device step and start copying its
        outputs, and the step's stamps, to the host (:func:`start_to_host`:
        queued on the stream before the next batch's step, so resolving
        this batch waits for this batch alone).  Each request's queue wait
        and the sub-phases (the step's own, from its ``last_step``, and
        the copy's start) are counted.  Returns the batch, or None after
        failing the futures."""
        t0 = time.perf_counter_ns()
        st = self.stats
        for it in items:
            st.queue_wait.add((t0 - it[2]) / 1e9)
        bid = next(self._batch_ids)
        n = len(items)
        pad = self.cfg.max_batch - n
        try:
            batch = [it[0] for it in items]
            batch += [batch[-1]] * pad
            if self._pool is not None:
                # ref mode: the indices go to the device, the frames (and
                # their letterbox) are gathered there
                idx = torch.as_tensor(batch, dtype=torch.int64).to(
                    self.rec.device)
                out = self.rec.step_raw(*(
                    self._pool[k].index_select(0, idx)
                    for k in ("frames", "packed") if k in self._pool))
            else:
                # the frames as they came: the frozen step gathers them
                # into its pinned staging buffer with threads
                out = self.rec.step_raw(batch)
            if not self.cfg.return_sr:
                out = {k: v for k, v in out.items() if k != "sr"}
            trace = getattr(self.rec, "last_step", None)
            phases = []
            if trace is not None and trace.phases and \
                    trace.phases[0][1] >= t0:      # this step's own
                phases = list(trace.phases)
                if trace.stamps is not None:
                    out = dict(out, stamps=trace.stamps)
            t1 = time.perf_counter_ns()
            fetch = start_to_host(out)
            phases.append(("host copy start", t1, time.perf_counter_ns()))
        except Exception as e:  # the collector must keep serving
            self._fail(items, e)
            return None
        for name, a, b in phases:
            st.dispatch_phase_s[name] = (st.dispatch_phase_s.get(name, 0.0)
                                         + (b - a) / 1e9)
        if self.tracer.enabled:
            for name, a, b in phases:
                self.tracer.record(name, a, b, bid, "dispatch")
            self.tracer.record("dispatch", t0, time.perf_counter_ns(), bid)
        return _Batch(bid, items, n, pad, fetch, t0)

    def _resolve(self, b: _Batch) -> None:
        """Wait for a launched batch's outputs on the host, assemble them
        and resolve its futures; sum its sub-phases and, where its step's
        stamps came back, each device stage's time."""
        st = self.stats
        t0 = time.perf_counter_ns()
        try:
            b.fetch.wait()
            t1 = time.perf_counter_ns()
            host = b.fetch()
            t2 = time.perf_counter_ns()
            stamps = host.pop("stamps", None)
            results = self.rec.assemble(host)
        except Exception as e:  # the collector must keep serving
            self._fail(b.items, e)
            return
        t3 = time.perf_counter_ns()
        st.batches += 1
        st.frames_padded += b.pad
        on = self.tracer.enabled
        for (_, fut, te, rid), res in zip(b.items, results[:b.n]):
            st.record((t3 - te) / 1e9)
            fut.set_result(res)
            if on:
                self.tracer.record("request", te, time.perf_counter_ns(),
                                   rid, lane="request")
                self.tracer.record("queue", te, b.t_dispatch, rid,
                                   "request", "request")
        t4 = time.perf_counter_ns()
        parts = (("copy wait", t0, t1), ("host conversion", t1, t2),
                 ("assemble", t2, t3), ("futures", t3, t4))
        for name, a, c in parts:
            st.resolve_phase_s[name] += (c - a) / 1e9
        if stamps is not None:
            self._add_stamps(st, stamps, b.id)
        if on:
            for name, a, c in parts:
                self.tracer.record(name, a, c, b.id, "resolve")
            self.tracer.record("resolve", t0, time.perf_counter_ns(), b.id)

    def _add_stamps(self, st: ServerStats, stamps, bid: int) -> None:
        """Each device stage's time and the step's (first stamp to last),
        summed over the stamp rows (one a replica); with spans on, a
        ``step`` span a row with a child a stage, on the host clock."""
        t, d = stamp_times(stamps)
        st.stamped_batches += 1
        st.step_device_s += float((t[:, -1] - t[:, 0]).sum()) / 1e9
        for name, ns in zip(DEVICE_STAGES, d.sum(0).tolist()):
            st.stage_s[name] += ns / 1e9
        if self.tracer.enabled:
            for row in t.tolist():
                self.tracer.record("step", row[0], row[-1], bid,
                                   lane="device")
                for name, a, c in zip(DEVICE_STAGES, row, row[1:]):
                    self.tracer.record(name, a, c, bid, "step", "device")

    def _loop(self) -> None:
        pending = None
        while not self._stop.is_set():
            t0 = time.perf_counter_ns()
            items = self._collect(block=pending is None)
            t1 = time.perf_counter_ns()
            nxt = self._dispatch(items) if items else None
            t2 = time.perf_counter_ns()
            if pending is not None:
                self._resolve(pending)
            st = self.stats     # a caller may have reset the stats
            st.collect_s += (t1 - t0) / 1e9
            st.dispatch_s += (t2 - t1) / 1e9
            st.resolve_s += (time.perf_counter_ns() - t2) / 1e9
            self.tracer.record("collect", t0, t1,
                               None if nxt is None else nxt.id)
            pending = nxt
        if pending is not None:
            self._resolve(pending)
