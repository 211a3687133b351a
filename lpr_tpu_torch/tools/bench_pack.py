"""What the packed detector input costs and saves, piece by piece
(counterpart of ``tools/bench_pack.py``).

    python -m lpr_tpu_torch.tools.bench_pack [--batch 32] [--iters 20]
        [--rounds 3] [--device cuda]

On 720p frames made from a seed (``tools/synth.py``), detector at
736x1280, the repo's plate detector in bf16, it times each piece of the
two ways into K1, beside the card's name and power limit:

- packed input (``PipelineConfig.packed_input``): the host letterbox
  (``ops/image.py`` ``letterbox_host``, the threaded C letterbox, into a
  new array and into the pinned staging buffer as the frozen step writes
  it, and its numpy reference ``letterbox_host_plain``; host clock, ms per
  frame, each beside a numpy copy of the same output bytes), the pinned
  upload of the letterboxed uint8 frames (and, beside it, the pageable
  one), and K1's uint8 instance on them;
- device letterbox: the raw frames' upload, the step's "letterbox+norm"
  stage (cast, /255, pad) followed by K1's bf16 instance, and K1 bf16
  alone.

Device pieces are timed with CUDA events (the mean of ``--iters`` calls,
best of ``--rounds``), each beside its bound: bytes over the memory rate
or operations over the bf16 peak for the device work, bytes over the host
link's rate (PCIe 5.0 x16, 64 GB/s each way) for an upload.  On the CPU
(``--device cpu``) every time is the host clock and no bound applies.
Run from the repo root.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from lpr_tpu_torch.tools import _timing

FRAME_HW = (720, 1280)
DET_HW = (736, 1280)

Row = Tuple[str, List[float], str]


def best_ms(fn: Callable[[], object], iters: int, rounds: int,
            device) -> List[float]:
    """Every round's ms per call (CUDA events on a card)."""
    return [_timing.event_ms(fn, iters, device) for _ in range(rounds)]


def host_ms_per(fn: Callable[[], object], n: int, rounds: int) -> List[float]:
    """Every round's host ms of one fn() call, divided by ``n``."""
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0) / n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--frame-hw", type=int, nargs=2, default=FRAME_HW)
    ap.add_argument("--det-hw", type=int, nargs=2, default=DET_HW)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.kernels import yolo_front as kf
    from lpr_tpu_torch.models.yolo import load_plate_detector
    from lpr_tpu_torch.ops.image import (letterbox, letterbox_host,
                                         letterbox_host_plain)
    from lpr_tpu_torch.tools.synth import synth_frames

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    B, (oh, ow) = args.batch, tuple(args.det_hw)
    plate = load_plate_detector("checkpoints/plate_det640.npz", dev).to(dtype)
    pack_u8 = kf.front_pack(plate, input_scale=1.0 / 255.0)
    pack = kf.front_pack(plate)
    frames = synth_frames(B, tuple(args.frame_hw), seed=0)
    lb = letterbox_host(frames, (oh, ow))
    out_copy = np.empty_like(lb)
    pin = dict(pin_memory=True) if on_card else {}
    lb_host = torch.from_numpy(lb)
    lb_pinned = torch.empty(lb.shape, dtype=torch.uint8, **pin)
    lb_pinned.copy_(lb_host)
    lb_dev = lb_pinned.to(dev)
    fr_dev = torch.from_numpy(frames).to(dev)
    it, rd = args.iters, args.rounds

    def up_pinned():
        lb_dev.copy_(lb_pinned, non_blocking=True)

    def up_pageable():
        lb_dev.copy_(lb_host)

    def device_letterbox():
        x = fr_dev.to(dtype) / 255.0
        return letterbox(x, (oh, ow), fill=0.0)[0].contiguous()

    x_lb = device_letterbox()
    lb_bytes = B * oh * ow * 3
    k1_u8 = kf.front_work(B, oh, ow, in_bytes=1)
    k1 = kf.front_work(B, oh, ow)
    # the letterbox reads the uint8 frames and writes the bf16 input
    lb_work = (0, fr_dev.numel() + B * oh * ow * 3 * 2)
    copy_ms = ("numpy copy of its output bytes",
               min(host_ms_per(lambda: np.copyto(out_copy, lb), B, rd)))
    rows: List[Tuple[str, List[float], object]] = [
        ("host letterbox (ms per frame)",
         host_ms_per(lambda: letterbox_host(frames, (oh, ow)), B, rd),
         copy_ms),
        ("host letterbox into pinned (ms per frame)",
         host_ms_per(lambda: letterbox_host(frames, (oh, ow), out=lb_pinned),
                     B, rd), copy_ms),
        ("host letterbox, numpy (ms per frame)",
         host_ms_per(lambda: letterbox_host_plain(frames, (oh, ow)), B, rd),
         copy_ms),
        ("upload, pinned (uint8 letterbox)", best_ms(up_pinned, it, rd, dev),
         lb_bytes / _timing.PCIE_BYTES_S * 1e3),
        ("upload, pageable (uint8 letterbox)",
         best_ms(up_pageable, it, rd, dev),
         lb_bytes / _timing.PCIE_BYTES_S * 1e3),
        ("K1 uint8", best_ms(lambda: kf.yolo_front(lb_dev, pack_u8), it, rd,
                             dev), _timing.bound_ms(k1_u8)),
        ("letterbox+norm + K1 bf16",
         best_ms(lambda: kf.yolo_front(device_letterbox(), pack), it, rd,
                 dev),
         _timing.bound_ms((k1[0], k1[1] + lb_work[1]))),
        ("letterbox+norm", best_ms(device_letterbox, it, rd, dev),
         _timing.bound_ms(lb_work)),
        ("K1 bf16", best_ms(lambda: kf.yolo_front(x_lb, pack), it, rd, dev),
         _timing.bound_ms(k1)),
    ]
    print(f"card: {_timing.card(dev)}")
    print(f"packed input vs device letterbox: batch {B}, frames "
          f"{args.frame_hw[0]}x{args.frame_hw[1]}, det {oh}x{ow}, "
          f"{str(dtype).replace('torch.', '')}; ms per call "
          f"({'CUDA events' if on_card else 'host clock'}, mean of {it} "
          f"calls, best of {rd} rounds); bounds at "
          f"{_timing.PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, "
          f"{_timing.PEAK_BYTES_S / 1e12:.2f} TB/s, host link "
          f"{_timing.PCIE_BYTES_S / 1e9:.0f} GB/s")
    for name, ms, bound in rows:
        if isinstance(bound, tuple) and isinstance(bound[0], str):
            beside = f"beside: {bound[0]} {bound[1]:.4f} ms"
        elif not on_card:
            beside = "bound: not applied on the CPU"
        elif isinstance(bound, tuple):
            beside = f"bound {bound[0]:.4f} ms ({bound[1]})"
        else:
            beside = f"bound {bound:.4f} ms (bytes over the host link)"
        print(f"{name:42s} {min(ms):9.4f} ms  {beside}; rounds "
              f"{[round(m, 4) for m in ms]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
