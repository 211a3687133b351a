"""Timing shared by the port's measuring tools.

- :func:`card` — the card's name and power limit, as ``nvidia-smi`` gives
  them, to print beside every number.
- :func:`event_ms` — device time per call from CUDA events around a run of
  calls (the host clock around a synchronize on the CPU).
- :func:`graph_ms` — device time per call from a run of calls captured as
  one CUDA graph: a kernel's time without its launch's host cost.
- :func:`host_ms` — wall-clock time per call around a run of calls, ended
  by ``torch.cuda.synchronize()``: what a host-bound caller waits.
- :func:`profile_window` — one ``torch.profiler`` window over a run of
  calls: device-busy ms per call (the sum of kernel times), the kernels
  (and copies) the device executed per call, the launches the host issued
  per call (kernel and graph launches, copies, memsets: one graph replay
  executes many kernels), and the kernels by device time.
- :func:`bound_ms` — the least time for a given work on an H100.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, List, Optional, Tuple

import torch

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12
# The host link of an H100 SXM: PCIe 5.0 x16, 64 GB/s each way (the data
# sheet's 128 GB/s counts both directions).
PCIE_BYTES_S = 64e9
# Host-side runtime and driver calls that put work on a stream.
_HOST_LAUNCH = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


def card(device: torch.device) -> str:
    """``name, power limit`` of the first card, or a note that the run is
    on the CPU."""
    if device.type != "cuda":
        return "CPU (no card; device time not measured)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def bound_ms(work: Tuple[int, int],
             peak: float = PEAK_BF16_FLOPS) -> Tuple[float, str]:
    """(ms, "operations" or "bytes") of (operations, bytes) at ``peak``
    (the bf16 peak by default; int8 operations at 1,979 TOPS) and the
    memory rate: the larger of the two times."""
    flops, nbytes = work
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def event_ms(fn: Callable[[], object], iters: int,
             device: torch.device = torch.device("cuda"),
             warmup: int = 3) -> float:
    """Mean time of fn() over ``iters`` calls after ``warmup`` calls: CUDA
    events on the current stream on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        return host_ms(fn, iters, device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], calls: int, rounds: int = 3) -> float:
    """Device ms per call of fn() on a card, the launch cost taken out:
    ``calls`` calls captured in one CUDA graph (after two warm-up calls on
    a side stream), replayed ``rounds`` times between CUDA events; the
    best round.  fn must be capturable: no host sync, no host data."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def host_ms(fn: Callable[[], object], calls: int,
            device: torch.device) -> float:
    """Wall-clock ms per call over ``calls`` calls, from a synchronized
    start to a synchronize after the last."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync(device)
    return 1e3 * (time.perf_counter() - t0) / calls


class Window:
    """What one profiled run of calls saw: ``busy_ms`` and ``launches`` (the
    kernels and copies the device executed) per call, None when the
    profiler saw no device event, as on the CPU; ``host_launches`` per
    call, the launch, graph-launch, copy and memset calls the host made
    (None likewise); and ``kernels``: (device ms per call, executions per
    call, name), most device time first."""

    def __init__(self, busy_ms: Optional[float], launches: Optional[float],
                 kernels: List[Tuple[float, float, str]],
                 host_launches: Optional[float] = None):
        self.busy_ms = busy_ms
        self.launches = launches
        self.kernels = kernels
        self.host_launches = host_launches


_MARK = "lpr_tpu_torch.profile_window"
# Idle time between the uncounted first call and the counted ones; device
# events are split at its middle.
_GAP_S = 0.01


def profile_window(fn: Callable[[], object], calls: int,
                   device: torch.device) -> Window:
    """Runs fn() once, waits ``_GAP_S``, then runs it ``calls`` times inside
    a marked range, under ``torch.profiler`` (CPU + CUDA), and sums per
    call the device events that start after the middle of the wait
    (kernels and copies; user annotations are left out).

    On an H100 a window lost its first device event now and then (4.8
    launches per call where every call launches 5), and a kernel launched
    just after the mark was once stamped before it: the device's time
    stamps can run ahead of the host's.  The uncounted first call takes the
    loss, and splitting in the idle gap tolerates an offset of up to half
    of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        sync(device)
        time.sleep(_GAP_S)
        with record_function(_MARK):
            for _ in range(calls):
                fn()
            sync(device)
    evts = prof.events()
    mark = min(e.time_range.start for e in evts
               if e.name == _MARK and e.device_type == DeviceType.CPU)
    t0 = mark - 1e6 * _GAP_S / 2
    by_name = {}
    host = 0
    for e in evts:
        if (e.device_type == DeviceType.CUDA and e.time_range.start >= t0
                and e.name != _MARK
                and not getattr(e, "is_user_annotation", False)):
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        elif (e.device_type == DeviceType.CPU and e.time_range.start >= mark
              and e.name.startswith(_HOST_LAUNCH)):
            host += 1
    if not by_name:
        return Window(None, None, [])
    kernels = sorted(((us / 1e3 / calls, n / calls, name)
                      for name, (us, n) in by_name.items()), reverse=True)
    return Window(sum(k[0] for k in kernels), sum(k[1] for k in kernels),
                  kernels, host / calls)


def fmt(v: Optional[float], spec: str = ".3f") -> str:
    """A measured number, or "not measured"."""
    return "not measured" if v is None else format(v, spec)
