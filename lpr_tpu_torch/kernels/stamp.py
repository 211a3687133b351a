"""Stage stamps of the device step (``csrc/stamp.cu``) and the clock they
share with the host.

:func:`stamp` writes a time in nanoseconds into one slot of an int64
tensor: on a CUDA tensor a one-thread kernel on the current stream writes
the card's ``%globaltimer`` when the stream reaches it (inside a CUDA
graph capture the launch is captured, and each replay writes anew); on a
CPU tensor the host's ``time.perf_counter_ns()`` is written at once.

:func:`calibrate` maps the card's clock onto ``time.perf_counter_ns()``:
the offset to subtract from a card stamp, and its uncertainty.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Tuple

import torch

from lpr_tpu_torch.kernels import refuse_export

Tensor = torch.Tensor

# Eager stamps a calibration launches.
CALIBRATION_LAUNCHES = 16


@functools.cache
def _lib():
    from lpr_tpu_torch.kernels._build import library

    lib = library("stamp")
    lib.lpr_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.lpr_stamp.restype = ctypes.c_int
    return lib


def stamp(buf: Tensor, i: int) -> None:
    """Write the time (ns) into element ``i`` of the contiguous int64
    tensor ``buf``: the card's ``%globaltimer`` when the current stream
    reaches the launch (CUDA), or ``time.perf_counter_ns()`` now (CPU)."""
    refuse_export("stamp")
    if buf.dtype != torch.int64 or not buf.is_contiguous():
        raise ValueError("stamps go into a contiguous int64 tensor")
    if not 0 <= i < buf.numel():
        raise IndexError(f"stamp slot {i} outside [0, {buf.numel()})")
    if buf.device.type == "cpu":
        buf.view(-1)[i] = time.perf_counter_ns()
        return
    if buf.device.type != "cuda":
        raise ValueError(f"stamp runs on cuda or cpu, not {buf.device}")
    lib = _lib()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.lpr_stamp(buf.data_ptr() + 8 * i, stream)
    if err != 0:
        raise RuntimeError(f"stamp kernel launch failed: cudaError {err}")


def calibrate(device: torch.device) -> Tuple[int, int]:
    """(offset, uncertainty) in ns of ``device``'s stamps against
    ``time.perf_counter_ns()``: a card stamp ``s`` happened at host time
    ``s - offset``.  Each of :data:`CALIBRATION_LAUNCHES` eager stamps is bracketed by the host
    time before its launch and after a synchronize; the offset is the
    least stamp minus the time before, and the uncertainty how far the
    greatest stamp minus the time after lies below it.  On the CPU both
    are 0."""
    if device.type != "cuda":
        return 0, 0
    buf = torch.zeros(CALIBRATION_LAUNCHES, dtype=torch.int64, device=device)
    before, after = [], []
    torch.cuda.synchronize(device)
    for i in range(CALIBRATION_LAUNCHES):
        before.append(time.perf_counter_ns())
        stamp(buf, i)
        torch.cuda.synchronize(device)
        after.append(time.perf_counter_ns())
    got = buf.tolist()
    offset = min(g - b for g, b in zip(got, before))
    low = max(g - a for g, a in zip(got, after))
    return offset, offset - low
