"""Where a recognizer step's time goes on the card.

    python -m lpr_tpu_torch.tools.profile_step [--batch 8] [--steps 5]

Builds the production recognizer (720p frames, detector at 736x1280,
bf16, the repo's checkpoints; K1 on), then prints, with the card's name and
power limit:

- ms/step from the host clock around ``torch.cuda.synchronize()``, best and
  all of three rounds, profiler off;
- from one profiled window (``torch.profiler``, CPU + CUDA): device busy
  time per step (the sum of kernel times), the device's idle share
  (1 - busy / ms per step), kernel launches per step, and the kernels
  with the most device time.

Run from the repo root (the checkpoints are read from ``checkpoints/``).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

FRAME_HW = (720, 1280)
DET_HW = (736, 1280)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler event has no device time")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    from lpr_tpu_torch.models.lpsr import load_lpsr
    from lpr_tpu_torch.models.yolo import (load_char_ocr_npz,
                                           load_plate_detector)
    from lpr_tpu_torch.pipeline.recognizer import (PipelineConfig,
                                                   PlateRecognizer)
    from lpr_tpu_torch.tools.synth import synth_frames

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    char, names = load_char_ocr_npz("checkpoints/char_ocr_synth.npz")
    rec = PlateRecognizer(
        load_plate_detector("checkpoints/plate_det640.npz"), char,
        load_lpsr("checkpoints/lpsr_synth_glare/best_model.npz"),
        PipelineConfig(det_hw=DET_HW, dtype=torch.bfloat16),
        char_names=names)
    frames = synth_frames(args.batch, FRAME_HW, seed=0)
    for _ in range(3):
        rec.step_raw(frames)
    torch.cuda.synchronize()

    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            rec.step_raw(frames)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0) / args.steps)
    best = min(step_ms)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            rec.step_raw(frames)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.steps
    launches = sum(e.count for e in kernels) / args.steps
    print(f"card: {card}")
    print(f"step: batch {args.batch}, {FRAME_HW[0]}p, det "
          f"{DET_HW[0]}x{DET_HW[1]}, bf16: best {best:.3f} ms/step "
          f"({1e3 * args.batch / best:.3f} frames/s); rounds {step_ms}")
    if not kernels:
        print("profiler: no device events (device time not measured)")
        return 0
    print(f"profiler: device busy {busy_ms:.3f} ms/step, idle share "
          f"{max(0.0, 1.0 - busy_ms / best):.3f}, {launches:.0f} kernel "
          f"launches/step")
    kernels.sort(key=_device_us, reverse=True)
    for e in kernels[:args.top]:
        print(f"  {_device_us(e) / 1e3 / args.steps:9.3f} ms/step "
              f"{e.count // args.steps:6d}x  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
