"""Training-step time of the port's trainers on the card (counterpart of
``tools/bench_train_step.py``; its ``lpsr`` model).

    python -m lpr_tpu_torch.tools.bench_train_step [--iters 20] [--tf32]
        [--device cpu]

- **lpsr**: the production LPSR (``LPSRConfig()``) at 32x192, batch 128,
  float32, one :meth:`LPSRTrainer.step` (forward, backward, Adam) on random
  inputs made from a seed on the device.

It prints one JSON line: the median ms/step over ``iters`` steps after
two warm-up steps (host clock around each step ended by
``torch.cuda.synchronize()``), images/s, the step's floating-point
operations and their share of the card's peak, beside the card's name and
power limit.  The operations are three times the forward's
(``kernels/lpsr.py`` ``lpsr_work``): the forward and the two backward
products (input and weight gradients) of every layer; Adam and the
elementwise work are not counted.  The peak is the one of the precision
the step ran at: 495 TFLOP/s TF32 with ``--tf32`` (cuDNN's and cuBLAS's
TF32 on), else 67 TFLOP/s, the float32 rate outside the tensor cores
(the H100 SXM data sheet at 700 W).  The detector model comes with the
detector trainers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    rec = bench_lpsr(dev, args.iters, LPSR_BATCH)
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
