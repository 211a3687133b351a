"""Where a recognizer step's time goes on the card.

    python -m lpr_tpu_torch.tools.profile_step [--batch 8] [--steps 5]
        [--frozen | --eager] [--packed] [--int8] [--eager-decode]
        [--device cuda]

Builds the production recognizer (720p frames, detector at 736x1280,
bf16, the repo's checkpoints; K1 on) with the step frozen into a CUDA
graph (``--frozen``, the default, as ``PipelineConfig.freeze_params``) or
launched op by op (``--eager``), on raw frames or with ``--packed`` on
host-letterboxed ones (``packed_input``), with ``--int8`` its detector in
int8 (``int8_detector``), with ``--eager-decode`` the whole grid decoded
(``lazy_decode=False``), then prints, with the card's name and power
limit:

- ms/step from the host clock around ``torch.cuda.synchronize()``, best and
  all of three rounds, profiler off;
- from one profiled window (``torch.profiler``, CPU + CUDA): device busy
  time per step (the sum of kernel times), the device's idle share
  (1 - busy / ms per step), the launches the host made per step (kernel
  and graph launches, copies, memsets: a frozen step is one graph replay
  and a few copies), the kernels the device executed per step (a graph's
  kernels included), and the kernels with the most device time.

Run from the repo root (the checkpoints are read from ``checkpoints/``).
"""

from __future__ import annotations

import argparse

import torch

from lpr_tpu_torch.tools import _timing

FRAME_HW = (720, 1280)
DET_HW = (736, 1280)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--frozen", dest="frozen", action="store_true",
                      default=True, help="the step as one CUDA graph "
                      "(freeze_params, the default)")
    mode.add_argument("--eager", dest="frozen", action="store_false",
                      help="the step launched op by op")
    ap.add_argument("--packed", action="store_true",
                    help="host-letterboxed uint8 detector input")
    ap.add_argument("--int8", action="store_true",
                    help="int8_detector: I1 + I2 after K1")
    ap.add_argument("--eager-decode", action="store_true",
                    help="lazy_decode=False: the whole grid decoded")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.models.lpsr import load_lpsr
    from lpr_tpu_torch.models.yolo import (load_char_ocr_npz,
                                           load_plate_detector)
    from lpr_tpu_torch.pipeline.recognizer import (PipelineConfig,
                                                   PlateRecognizer)
    from lpr_tpu_torch.tools.synth import synth_frames

    dev = resolve_device(args.device)
    card = _timing.card(dev)
    char, _, ck = load_char_ocr_npz("checkpoints/char_ocr_synth.npz", dev)
    names = ck.names
    rec = PlateRecognizer(
        load_plate_detector("checkpoints/plate_det640.npz", dev), char,
        load_lpsr("checkpoints/lpsr_synth_glare/best_model.npz", device=dev),
        PipelineConfig(det_hw=DET_HW, dtype=torch.bfloat16,
                       freeze_params=args.frozen, packed_input=args.packed,
                       int8_detector=args.int8,
                       lazy_decode=not args.eager_decode),
        char_names=names, device=dev)
    frames = synth_frames(args.batch, FRAME_HW, seed=0)
    for _ in range(3):
        rec.step_raw(frames)
    _timing.sync(dev)

    def step():
        rec.step_raw(frames)

    step_ms = [_timing.host_ms(step, args.steps, dev) for _ in range(3)]
    best = min(step_ms)
    win = _timing.profile_window(step, args.steps, dev)
    frozen = args.frozen and dev.type == "cuda"
    print(f"card: {card}")
    print(f"step ({'frozen: one CUDA graph' if frozen else 'eager'}"
          f"{', packed input' if args.packed else ''}"
          f"{', int8 detector' if args.int8 else ''}"
          f"{', eager decode' if args.eager_decode else ''}): batch "
          f"{args.batch}, "
          f"{FRAME_HW[0]}p, det {DET_HW[0]}x{DET_HW[1]}, bf16: best "
          f"{best:.3f} ms/step ({1e3 * args.batch / best:.3f} frames/s); "
          f"rounds {step_ms}")
    if win.busy_ms is None:
        print("profiler: no device events (device time not measured)")
        return 0
    print(f"profiler: device busy {win.busy_ms:.3f} ms/step, idle share "
          f"{max(0.0, 1.0 - win.busy_ms / best):.3f}, "
          f"{win.host_launches:.1f} host launches/step, "
          f"{win.launches:.1f} kernels executed/step")
    for ms, n, name in win.kernels[:args.top]:
        print(f"  {ms:9.3f} ms/step {n:6.0f}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
