"""Pipeline profiling variants (counterpart of ``tools/prof_pipeline.py``),
driven by environment variables:

    PROF_DET_HW=1280   square detector input size; a multiple of 64, which
                       K1 needs (H % 32, W % 64)
    PROF_BATCH=8       frames per step
    PROF_STAGE=full    full | det_only | det_nms
    PROF_STEPS=10      steps, each on its own batch of frames

    python -m lpr_tpu_torch.tools.prof_pipeline [--device cuda]

The recognizer is the production one (bf16, the repo's checkpoints, K1
and K2 on) at the square detector size; frames are 720p, made with numpy
(``tools/synth.py``).  ``full`` runs the whole step, ``det_only`` the
upload, letterbox and detector, ``det_nms`` those and the plate NMS, each
through the recognizer's own stage methods.  Prints ms/step and frames/s
(host clock from a synchronize to a synchronize after the last step) and
the first pass's time, which includes building the kernels.  Run from the
repo root.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from lpr_tpu_torch.tools import _timing

STAGES = ("full", "det_only", "det_nms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    det = int(os.environ.get("PROF_DET_HW", "1280"))
    B = int(os.environ.get("PROF_BATCH", "8"))
    stage = os.environ.get("PROF_STAGE", "full")
    N = int(os.environ.get("PROF_STEPS", "10"))
    if stage not in STAGES:
        raise SystemExit(f"unknown stage {stage}: one of {STAGES}")

    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.tools.profile_stages import build_recognizer
    from lpr_tpu_torch.tools.synth import synth_frames

    dev = resolve_device(args.device)
    rec = build_recognizer(dev, det_hw=(det, det))
    frames = synth_frames(N * B, (720, 1280), seed=0).reshape(
        N, B, 720, 1280, 3)

    def body(fr):
        if stage == "full":
            return rec.step_raw(fr)
        x = rec._upload(fr)
        _, lb, _, _ = rec._letterbox(x)
        raws = rec._detect(lb)
        return raws if stage == "det_only" else rec._plate_nms(raws)

    def run_all():
        for fr in frames:
            body(fr)

    t0 = time.perf_counter()
    with torch.inference_mode():
        run_all()
        _timing.sync(dev)
        t_first = time.perf_counter() - t0
        dt = _timing.host_ms(run_all, 1, dev) / 1e3
    print(f"card: {_timing.card(dev)}")
    print(f"stage={stage} det={det} B={B}: {dt / N * 1e3:.1f} ms/step "
          f"({B * N / dt:.1f} fps)  [first pass {t_first:.0f}s]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
