"""Where K1's time goes: its stage variants timed on the card (counterpart
of ``tools/probe_front_stages.py``).

    python -m lpr_tpu_torch.tools.probe_front_stages [--batch 8]
        [--iters 20] [--rounds 3] [--device cuda]

Each variant (``kernels/yolo_front.py`` ``front_stage``) is K1's own code
cut after one stage: ``dma`` stages the space-to-depth input tile in
shared memory, ``stem`` adds the stem, ``down`` the down conv, ``full`` is
K1.  Each writes K1's output shape, so the differences between them are
what each stage costs inside K1.  The default batch is 8, the port's step
batch (the JAX tool's default is 32).  The weights are the real
``checkpoints/plate_det640.npz`` (the JAX tool drew random ones, having no
checkpoint), the frames 720p from ``tools/synth.py``, letterboxed to
736x1280 bf16 as the step letterboxes them.  Per variant it prints the
best and every round's ms (CUDA events, mean of ``--iters`` launches),
its bound from ``front_stage_work`` with what bounds it, and its share of
``full``'s time, beside the card's name and power limit.  On the CPU the
variants are their plain versions, on the host clock.  Run from the repo
root.
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import torch

from lpr_tpu_torch.tools import _timing

FRAME_HW = (720, 1280)
DET_HW = (736, 1280)


def probe(x: torch.Tensor, packed: Dict[str, torch.Tensor], iters: int,
          rounds: int) -> Dict[str, List[float]]:
    """ms per launch of each variant on letterboxed frames ``x``, one
    entry per round (each the mean of ``iters`` launches after a warm-up),
    rounds interleaved across the variants."""
    from lpr_tpu_torch.kernels.yolo_front import STAGES, front_stage

    out: Dict[str, List[float]] = {s: [] for s in STAGES}
    for _ in range(rounds):
        for s in STAGES:
            out[s].append(_timing.event_ms(
                lambda: front_stage(x, packed, s), iters, x.device))
    return out


def report(times: Dict[str, List[float]], batch: int, h: int,
           w: int) -> List[str]:
    """One line per variant: best ms, bound, share of full, all rounds."""
    from lpr_tpu_torch.kernels.yolo_front import front_stage_work

    full = min(times["full"])
    lines = []
    for s, ms in times.items():
        b_ms, b_by = _timing.bound_ms(front_stage_work(s, batch, h, w))
        lines.append(f"front[{s:4s}] {min(ms):9.4f} ms  bound {b_ms:.4f} ms "
                     f"({b_by}, {min(ms) / b_ms:6.1f}x)  "
                     f"{100 * min(ms) / full:5.1f}% of full  rounds "
                     f"{[round(t, 4) for t in ms]}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--frame-hw", type=int, nargs=2, default=FRAME_HW)
    ap.add_argument("--det-hw", type=int, nargs=2, default=DET_HW)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.kernels.yolo_front import front_pack
    from lpr_tpu_torch.models.yolo import load_plate_detector
    from lpr_tpu_torch.ops.image import letterbox
    from lpr_tpu_torch.tools.synth import synth_frames

    dev = resolve_device(args.device)
    plate = load_plate_detector("checkpoints/plate_det640.npz", dev)
    packed = front_pack(plate.to(torch.bfloat16))
    frames = torch.from_numpy(synth_frames(args.batch, tuple(args.frame_hw),
                                           seed=0)).to(dev)
    x = letterbox(frames.to(torch.bfloat16) / 255.0, tuple(args.det_hw),
                  fill=0.0)[0].contiguous()
    times = probe(x, packed, args.iters, args.rounds)
    print(f"card: {_timing.card(dev)}")
    clock = ("CUDA events" if dev.type == "cuda"
             else "plain versions on the host clock")
    print(f"K1 stage variants at {tuple(x.shape)} bf16, {clock}, mean of "
          f"{args.iters} launches, best of {args.rounds} rounds; bounds "
          f"for an H100")
    for line in report(times, *x.shape[:3]):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
