"""Training-step time of the port's trainers on the card (counterpart of
``tools/bench_train_step.py``; its ``det`` and ``lpsr`` models).

    python -m lpr_tpu_torch.tools.bench_train_step [--models det lpsr]
        [--iters 20] [--tf32] [--device cpu]

- **det**: the production detector trainer, yolov5s nc=11 at 640x640,
  batch 16, float32: one :meth:`YoloTrainer.step` (the training forward
  with batch statistics, the full loss, backward, Nesterov SGD, the EMA)
  on a fixed random batch with three labels an image (classes 7 and 8,
  the JAX tool's draws).
- **lpsr**: the production LPSR (``LPSRConfig()``) at 32x192, batch 128,
  float32, one :meth:`LPSRTrainer.step` (forward, backward, Adam) on random
  inputs made from a seed on the device.

It prints one JSON line a model: the median ms/step over ``iters`` steps
after two warm-up steps (host clock around each step ended by
``torch.cuda.synchronize()``), images/s, the step's floating-point
operations and their share of the card's peak, beside the card's name and
power limit.  The detector's operations are counted by
``torch.utils.flop_counter`` over one forward and backward (convolutions
and matrix products, forward and both backward products); the LPSR's are
three times the forward's (``kernels/lpsr.py`` ``lpsr_work``).  The
optimizer and the elementwise work are not counted in either.  The peak is
the one of the precision the step ran at: 495 TFLOP/s TF32 with
``--tf32`` (cuDNN's and cuBLAS's TF32 on), else 67 TFLOP/s, the float32
rate outside the tensor cores (the H100 SXM data sheet at 700 W).
The detector's line also says where its step's time goes: device-busy
ms, kernels and host launches a step, the top kernels
(:func:`profile_steps`; None on the CPU).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Optional

import torch

from lpr_tpu_torch.kernels.conv_int8 import PEAK_FP32_FLOPS
from lpr_tpu_torch.tools._timing import PEAK_TF32_FLOPS, card, sync

LPSR_HW = (32, 192)
LPSR_BATCH = 128            # the JAX tool's training batch
WARMUP = 2


def bench_lpsr(device: torch.device, iters: int, batch: int = LPSR_BATCH,
               seed: int = 0) -> dict:
    """The median step time of :meth:`LPSRTrainer.step` over ``iters``
    steps after ``WARMUP``, at the precision the caller set; one record of
    the JSON line."""
    from lpr_tpu_torch.kernels.lpsr import lpsr_work
    from lpr_tpu_torch.models.lpsr import LPSRConfig
    from lpr_tpu_torch.train.lpsr import LPSRTrainer

    trainer = LPSRTrainer(lpsr_cfg=LPSRConfig(), device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    state = trainer.init(g)
    lr = torch.rand((batch, *LPSR_HW, 3), generator=g, device=device)
    hr = torch.rand((batch, *LPSR_HW, 1), generator=g, device=device)
    for _ in range(WARMUP):
        state, loss = trainer.step(state, lr, hr)
    sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        state, loss = trainer.step(state, lr, hr)
        sync(device)
        times.append(time.perf_counter() - t0)
    if not torch.isfinite(loss):
        raise RuntimeError(f"the LPSR step's loss is {float(loss)}")
    step_s = statistics.median(times)
    flops = 3 * lpsr_work(batch, *LPSR_HW, in_bytes=4)[0]
    return {"model": f"lpsr_{LPSR_HW[1]}x{LPSR_HW[0]}_b{batch}_f32",
            "step_ms": step_s * 1e3, "imgs_per_s": batch / step_s,
            "flops_per_step": flops, "loss": float(loss)}


DET_HW = (640, 640)
DET_BATCH = 16              # the JAX tool's production step
DET_NC = 11


def det_batch(batch: int, hw=None, seed: int = 0):
    """(images (B, H, W, 3) in [0, 1], labels (B, 64, 5)): uint8 noise
    (``hw``, default ``DET_HW``) and three labels an image, class 7 or 8,
    drawn as the JAX tool draws them (``tools/bench_train_step.py``
    ``bench_det``)."""
    import numpy as np

    hw = DET_HW if hw is None else hw
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (batch, *hw, 3), np.uint8)
    labels = np.zeros((batch, 64, 5), np.float32)
    for i in range(batch):
        for t in range(3):
            labels[i, t] = [rng.choice([7, 8]), rng.uniform(0.2, 0.8),
                            rng.uniform(0.2, 0.8), rng.uniform(0.02, 0.2),
                            rng.uniform(0.02, 0.08)]
    return images.astype(np.float32) / 255.0, labels


def det_trainer(device: torch.device):
    from lpr_tpu_torch.models.yolo import yolov5
    from lpr_tpu_torch.train.yolo import YoloTrainConfig, YoloTrainer

    return YoloTrainer(yolov5("s", nc=DET_NC), YoloTrainConfig(epochs=10),
                       steps_per_epoch=100, device=device)


def det_step_flops(trainer, state, images, labels) -> float:
    """Floating-point operations of one forward and backward of the
    detector step (``torch.utils.flop_counter``)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        trainer.grads(state["params"], images, labels)
    return float(fc.get_total_flops())


def bench_det(device: torch.device, iters: int,
              batch: Optional[int] = None, seed: int = 0) -> dict:
    """The median step time of :meth:`YoloTrainer.step` (yolov5s, nc=11,
    ``DET_HW``) at ``batch`` (default ``DET_BATCH``) over ``iters`` steps
    after ``WARMUP``, at the precision the caller set, and where the
    step's time goes (:func:`profile_steps`); one record of the JSON
    line."""
    batch = DET_BATCH if batch is None else batch
    trainer = det_trainer(device)
    state = trainer.init(torch.Generator().manual_seed(seed))
    x, lab = det_batch(batch, seed=seed)
    images = torch.from_numpy(x).to(device)
    labels = torch.from_numpy(lab).to(device)
    flops = det_step_flops(trainer, state, images, labels)
    for _ in range(WARMUP):
        state, loss, _ = trainer.step(state, images, labels)
    sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        state, loss, _ = trainer.step(state, images, labels)
        sync(device)
        times.append(time.perf_counter() - t0)
    if not torch.isfinite(loss):
        raise RuntimeError(f"the detector step's loss is {float(loss)}")
    step_s = statistics.median(times)
    rec = {"model": f"det_yolov5s_nc{DET_NC}_{DET_HW[1]}x{DET_HW[0]}"
                    f"_b{batch}_f32",
           "step_ms": step_s * 1e3, "imgs_per_s": batch / step_s,
           "flops_per_step": flops, "loss": float(loss)}
    rec.update(profile_steps(lambda: trainer.step(state, images, labels),
                             device))
    return rec


def profile_steps(step, device: torch.device, calls: int = 3) -> dict:
    """Where a step's time goes (``tools/_timing.py`` ``profile_window``
    over ``calls`` steps): device-busy ms, kernels executed and host
    launches per step, and the eight kernels with the most device time
    (ms a step, executions a step, name)."""
    from lpr_tpu_torch.tools._timing import profile_window

    w = profile_window(step, calls, device)
    return {"device_busy_ms": w.busy_ms, "kernels_per_step": w.launches,
            "host_launches_per_step": w.host_launches,
            "top_kernels": [(round(ms, 3), round(n, 1), name[:90])
                            for ms, n, name in w.kernels[:8]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+", default=["det", "lpsr"],
                    choices=["det", "lpsr"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tf32", action="store_true",
                    help="cuDNN and cuBLAS in TF32 (default: off)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from lpr_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = args.tf32
    torch.backends.cuda.matmul.allow_tf32 = args.tf32
    peak, precision = ((PEAK_TF32_FLOPS, "tf32") if args.tf32
                       else (PEAK_FP32_FLOPS, "fp32 CUDA cores"))
    for name in args.models:
        rec = (bench_det(dev, args.iters) if name == "det"
               else bench_lpsr(dev, args.iters, LPSR_BATCH))
        rec["device"] = card(dev)
        if dev.type == "cuda":
            rec["peak_precision"] = precision
            rec["peak_fraction"] = (rec["flops_per_step"]
                                    / (rec["step_ms"] / 1e3) / peak)
        else:   # a CPU run's time is not a device metric
            rec["peak_fraction"] = None
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
