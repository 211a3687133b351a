"""End-to-end pipeline CLI (counterpart of ``lpr_tpu/cli/run.py``, the
reference ``inference/run.py``): reads a video file or image folder, runs
the batched recognizer on the card, and writes annotated frames (and with
``--panel`` per-frame detail panels) to an output directory.

    python -m lpr_tpu_torch.cli.run --source frames/ \\
        --d-weights checkpoints/plate_det640.npz \\
        --r-weights checkpoints/char_ocr_synth.npz \\
        --sr-weights checkpoints/lpsr_synth_glare/best_model.npz --out out/

The recognizer is the default one at a square ``--imgsz-det`` detector in
bf16: K1 for the detector's layers 0-2, K2 for LPSR, the step frozen into
a CUDA graph.  Frames and panels are written as PNG (the port has no JPEG
encoder).  Image folders and files are PNG or JPEG
(:func:`lpr_tpu_torch.imageio.read_rgb`); a video or stream needs cv2,
imported only then.  ``--r-weights`` takes the repo's npz checkpoint or
the reference's ``char.pt``; ``--d-weights`` takes the repo's npz
checkpoint only: the port builds no randomly initialised detector, so
anything else raises.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterator, List

import numpy as np

FRAME_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="License-plate recognition")
    p.add_argument("--d-weights", type=str, default=None,
                   help="plate detector weights (the repo's .npz, e.g. "
                        "checkpoints/plate_det640.npz); required")
    p.add_argument("--r-weights", type=str, required=True,
                   help="char OCR weights (.npz)")
    p.add_argument("--sr-weights", type=str, required=True,
                   help="LPSR weights (.npz or .pth)")
    p.add_argument("--source", type=str, required=True,
                   help="video file or image folder")
    p.add_argument("--out", type=str, default="out")
    p.add_argument("--imgsz-det", type=int, default=1280)   # run.py:108
    p.add_argument("--d-conf", type=float, default=0.7)     # run.py:110
    p.add_argument("--r-conf", type=float, default=0.25)    # run.py:111
    p.add_argument("--iou", type=float, default=0.3)        # run.py:112
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--panel", action="store_true",
                   help="also write per-frame detail panels")
    p.add_argument("--step", action="store_true",
                   help="interactive stepping: pause after each annotated "
                        "frame and wait for Enter on stdin ('q' quits) — "
                        "the headless counterpart of the reference's "
                        "per-frame keypress loop (inference/run.py:273-277)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def frame_source(source: str) -> Iterator[np.ndarray]:
    """Yield RGB uint8 frames: an image folder (sorted), a single image, or
    a video file, stream URL or webcam index through cv2."""
    from lpr_tpu_torch import imageio

    if os.path.isdir(source):
        for f in sorted(os.listdir(source)):
            if f.lower().endswith(FRAME_SUFFIXES):
                yield imageio.read_rgb(os.path.join(source, f))
        return
    if source.lower().endswith(FRAME_SUFFIXES):
        yield imageio.read_rgb(source)
        return
    import cv2

    cap = cv2.VideoCapture(int(source) if source.isdigit() else source)
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield frame[:, :, ::-1]  # BGR -> RGB
    finally:
        cap.release()


def build_recognizer(args):
    """The PlateRecognizer of the CLI's flags: the detector (npz), char
    OCR (npz or the reference's .pt) and LPSR (npz, .pth or .onnx) at
    ``--imgsz-det`` square, bf16."""
    import torch

    from lpr_tpu_torch.models.lpsr import load_lpsr
    from lpr_tpu_torch.models.yolo import load_char_ocr, load_plate_detector
    from lpr_tpu_torch.pipeline.recognizer import (PipelineConfig,
                                                   PlateRecognizer)

    dev = args.device
    if not (args.d_weights and args.d_weights.endswith(".npz")):
        raise ValueError(
            f"--d-weights {args.d_weights!r}: the port loads the plate "
            f"detector from the repo's npz checkpoint (e.g. "
            f"checkpoints/plate_det640.npz); it builds no randomly "
            f"initialised detector, where the JAX CLI keeps random weights "
            f"for anything else, a .pt included")
    plate = load_plate_detector(args.d_weights, device=dev)
    char, _, ck = load_char_ocr(args.r_weights, device=dev)
    names = ck.names
    lpsr = load_lpsr(args.sr_weights, device=dev)
    cfg = PipelineConfig(det_hw=(args.imgsz_det, args.imgsz_det),
                         det_conf=args.d_conf, ocr_conf=args.r_conf,
                         iou=args.iou, dtype=torch.bfloat16)
    return PlateRecognizer(plate, char, lpsr, cfg, char_names=names,
                           device=dev)


def _step_pause(idx: int) -> bool:
    """Block until the user presses Enter; return False to stop the run.

    The headless form of the reference's frame-by-frame keypress stepping
    (``inference/run.py:273-277``: ``cv2.waitKey(0)``, 'q' breaks): the
    pause reads a line from stdin.  EOF also stops, so piped input ends
    the run cleanly."""
    try:
        line = input(f"[frame {idx}] Enter=next, q=quit> ")
    except EOFError:
        return False
    return not line.strip().lower().startswith("q")


def main(argv=None):
    """Run the CLI; returns the per-frame plate lists it printed."""
    args = parse_args(argv)
    from lpr_tpu_torch.imageio import write_png
    from lpr_tpu_torch.pipeline.annotate import annotate_frame, side_panel

    rec = build_recognizer(args)
    os.makedirs(args.out, exist_ok=True)

    batch: List[np.ndarray] = []
    done: List[list] = []
    idx = 0
    stopped = False
    t_last = time.perf_counter()
    fps = 0.0

    def flush(frames: List[np.ndarray]):
        nonlocal idx, fps, t_last, stopped
        n = len(frames)
        padded = frames + [frames[-1]] * (args.batch - n)
        results = rec.recognize(np.stack(padded))[:n]
        now = time.perf_counter()
        fps = n / (now - t_last)
        t_last = now
        for f, plates in zip(frames, results):
            write_png(os.path.join(args.out, f"frame_{idx:06d}.png"),
                      annotate_frame(f, plates, fps=fps))
            if args.panel and plates:
                write_png(os.path.join(args.out, f"panel_{idx:06d}.png"),
                          side_panel(plates))
            for p in plates:
                print(f"frame {idx}: {p['text']!r} / SR {p['text_sr']!r} "
                      f"conf {p['score']:.2f}")
            done.append(plates)
            idx += 1
            if args.step and not _step_pause(idx - 1):
                stopped = True
                return
        if args.step:
            # don't charge the human pause time to the next flush's fps
            t_last = time.perf_counter()

    for frame in frame_source(args.source):
        batch.append(frame)
        if len(batch) < args.batch:
            continue
        if len({b.shape for b in batch}) != 1:
            raise ValueError(f"mixed frame sizes in one batch: "
                             f"{sorted({b.shape for b in batch})}")
        flush(batch)
        batch.clear()
        if stopped or (args.max_frames and idx >= args.max_frames):
            break
    if batch and not stopped and not (args.max_frames
                                      and idx >= args.max_frames):
        flush(batch)  # trailing partial batch (padded to the batch shape)
    print(f"done: {idx} frames -> {args.out} (last fps {fps:.1f})")
    return done


if __name__ == "__main__":
    main()
