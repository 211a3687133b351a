"""End-to-end benchmark of the port: frames per second per card for
detect -> SR -> OCR (counterpart of the repo's root ``bench.py``).

    python -m lpr_tpu_torch.bench [--device cuda] [--eager]

The root bench's configuration: 720p frames made from a seed
(``lpr_tpu_torch/tools/synth.py``, one batch tiled over the steps as the
root bench tiles its frames), the detector at rect 736x1280, bf16, batch
32, 30 chained steps, the repo's checkpoints (``plate_det640.npz``,
``char_ocr_synth.npz``, ``lpsr_synth_glare``), the recognizer's default
``freeze_params`` (one CUDA graph a step; ``--eager`` launches it op by
op).  Every step's frames (and letterboxed frames) sit on the device before
the clock starts; the steps run back to back, each summed into a device
accumulator, and one synchronize ends a run.  Best of ``BENCH_REPS`` runs.

Environment switches, as the root bench's: ``BENCH_PACKED`` (default 1:
``packed_input``, the host-letterboxed uint8 detector input), ``BENCH_REPS``
(4), ``BENCH_MFU`` (1: count the FLOPs), ``BENCH_BATCH`` (32),
``BENCH_STEPS`` (30), ``BENCH_RECT`` (1: detector height snapped to the
frame's aspect), ``BENCH_INT8`` (0; 1: ``int8_detector``, the detector's
convolutions after K1 in int8 through kernels I1 and I2).

Prints the card's name and power limit (``card: ...``), then one JSON
line with the root bench's keys: ``metric``, ``value``
(frames/s), ``unit``, ``flops_per_frame`` and ``mfu_pct`` (against the
H100's dense bf16 peak, :data:`PEAK_BF16_FLOPS`), and the card's name and
power limit under ``gpu``.  FLOPs per step are counted, not timed:
``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products of one eager step, and on a card the hand-written kernels,
which it cannot see, add their own counts (``front_work``, ``mid_work``,
``lpsr_work``, and I2's int8 operations, ``conv_int8_work``, counted as
FLOPs against the bf16 peak as the root bench counts them).  On the CPU (``--device cpu``) the counter sees the
kernels' plain versions instead, and no device figure is measured: the
run checks the program and prints ``value`` and ``mfu_pct`` as null.
Run from the repo root.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

# The H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
FRAME_HW = (720, 1280)
METRIC = "e2e_detect_sr_ocr_frames_per_sec_per_chip"


def det_hw(frame_hw, det_w: int = 1280, rect: bool = True):
    """The root bench's detector geometry: width ``det_w``, height snapped
    to the frame's aspect at a multiple of 32 (rect), else square."""
    if not rect:
        return det_w, det_w
    return (int(math.ceil(frame_hw[0] * det_w / frame_hw[1] / 32) * 32),
            det_w)


def step_flops(rec, frames: torch.Tensor, packed) -> int:
    """FLOPs of one step: what FlopCounterMode sees of the eager step, plus
    on a card the work of the kernels it launched through ctypes."""
    from torch.utils.flop_counter import FlopCounterMode

    from lpr_tpu_torch.kernels.conv_int8 import conv_int8_work
    from lpr_tpu_torch.kernels.lpsr import lpsr_work
    from lpr_tpu_torch.kernels.yolo_front import front_work
    from lpr_tpu_torch.kernels.yolo_mid import mid_work
    from lpr_tpu_torch.models.yolo import quantized_convs
    from lpr_tpu_torch.ops.nn import _resolve_padding

    int8_ops = []

    def count_int8(conv, args):
        c = conv.conv
        x = getattr(args[0], "x", args[0])     # a tensor or its QuantizedAct
        int8_ops.append(conv_int8_work(
            x.shape, conv.w_q.shape, (c.stride, c.stride),
            _resolve_padding(c.padding, *conv.w_q.shape[:2]))[0])

    hooks = ([m.register_forward_pre_hook(count_int8) for m in
              quantized_convs(rec.plate_model).values()]
             if rec.device.type == "cuda" else [])
    try:
        with FlopCounterMode(display=False) as counter:
            rec.step_eager(frames, packed)
    finally:
        for h in hooks:
            h.remove()
    flops = counter.get_total_flops() + sum(int8_ops)
    if rec.device.type == "cuda":
        B = int(frames.shape[0])
        h, w = rec.cfg.det_hw
        if rec._front is not None:
            flops += front_work(B, h, w)[0]
        if rec._mid is not None:
            flops += mid_work(B, h // 4, w // 4)[0]
        if rec._lpsr is not None:
            flops += lpsr_work(B * rec.cfg.max_plates, *rec.cfg.sr_hw)[0]
    return int(flops)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="freeze_params=False: the step op by op")
    ap.add_argument("--frame-hw", type=int, nargs=2, default=FRAME_HW)
    ap.add_argument("--det-w", type=int, default=1280)
    args = ap.parse_args(argv)

    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.tools import _timing
    from lpr_tpu_torch.tools.profile_stages import build_recognizer
    from lpr_tpu_torch.tools.synth import synth_frames

    dev = resolve_device(args.device)
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    steps = int(os.environ.get("BENCH_STEPS", "30"))
    reps = int(os.environ.get("BENCH_REPS", "4"))
    packed_mode = os.environ.get("BENCH_PACKED", "1") == "1"
    int8 = os.environ.get("BENCH_INT8", "0") == "1"
    frame_hw = tuple(args.frame_hw)
    hw = det_hw(frame_hw, args.det_w, os.environ.get("BENCH_RECT", "1") == "1")
    rec = build_recognizer(dev, torch.bfloat16, hw,
                           freeze_params=not args.eager,
                           packed_input=packed_mode, int8_detector=int8)

    # one batch on the device, tiled over the steps
    one = synth_frames(batch, frame_hw, seed=0)
    frames = torch.from_numpy(one).to(dev).expand(steps, *one.shape)
    frames = frames.contiguous()
    packed = [None] * steps
    if packed_mode:
        lb = torch.from_numpy(rec.host_letterbox(one)).to(dev)
        packed = lb.expand(steps, *lb.shape).contiguous()

    def run() -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(steps):
            out = rec.step_raw(frames[i], packed[i])
            acc += (out["plate_boxes"].sum() + out["chars_sr"]["scores"].sum()
                    + out["sr"].mean())
        _timing.sync(dev)
        return acc

    acc = run()                          # capture (or warm-up) and check
    if not torch.isfinite(acc):
        raise AssertionError(f"non-finite step outputs ({acc.item()})")
    run_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        run_ms.append(1e3 * (time.perf_counter() - t0))
    fps = batch * steps / (min(run_ms) / 1e3)
    on_card = dev.type == "cuda"
    record = {"metric": METRIC, "value": fps if on_card else None,
              "unit": "frames/s"}
    if os.environ.get("BENCH_MFU", "1") == "1":
        flops = step_flops(rec, frames[0], packed[0])
        record["flops_per_frame"] = flops // batch
        record["mfu_pct"] = (100.0 * flops * (fps / batch) / PEAK_BF16_FLOPS
                             if on_card else None)
    record.update({
        "gpu": _timing.card(dev), "packed_input": packed_mode,
        "int8_detector": int8,
        "freeze_params": not args.eager, "batch": batch, "steps": steps,
        "frame_hw": list(frame_hw), "det_hw": list(hw), "run_ms": run_ms,
    })
    if not on_card:
        record["cpu_frames_per_s"] = fps
    print(f"card: {record['gpu']}")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
