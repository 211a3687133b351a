"""SR-improvement case finder (counterpart of
``lpr_tpu/cli/find_improvement.py``, the reference
``evaluation/find_improvement.py``).

Runs the two-path evaluation over a folder, then selects the "convincing
improvement" cases: the raw OCR's mean confidence below ``--low-conf``,
and the SR OCR correct with confidence at least ``--high-conf`` (reference
gates, find_improvement.py:237-240).  For each it re-runs the evaluator's
device batch on that image alone (LPSR through K2 on the card) and writes
a report panel: the ground truth, the LR image with the raw OCR, the SR
image with the SR OCR.

    python -m lpr_tpu_torch.cli.find_improvement --eval-folder plates/ \\
        --sr-weights checkpoints/lpsr_synth_glare/best_model.npz \\
        --ocr-weights checkpoints/char_ocr_synth.npz --out improvements/

``--clahe`` applies CLAHE to the raw path's gray image (reference :43-67)
through cv2, and raises where cv2 is not installed.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np

PANEL_W, PANEL_H = 420, 260
PANEL_BG = (40, 40, 40)
GT_COLOR = (120, 180, 255)
OK_COLOR, BAD_COLOR = (120, 255, 120), (255, 100, 100)


def clahe_gray(img_u8: np.ndarray, clip: float = 2.0, tiles: int = 8):
    """CLAHE on the gray image, as RGB (reference :43-67), through cv2."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("--clahe needs OpenCV (cv2), which does not "
                           "import here") from e
    g = cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY)
    out = cv2.createCLAHE(clipLimit=clip,
                          tileGridSize=(tiles, tiles)).apply(g)
    return np.stack([out] * 3, -1)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Find convincing SR improvements")
    p.add_argument("--eval-folder", required=True)
    p.add_argument("--sr-weights", required=True)
    p.add_argument("--ocr-weights", required=True)
    p.add_argument("--out", default="improvements")
    p.add_argument("--ocr-conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.3)
    p.add_argument("--low-conf", type=float, default=0.45)
    p.add_argument("--high-conf", type=float, default=0.7)
    p.add_argument("--clahe", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def is_improvement(r: Dict, low_conf: float, high_conf: float) -> bool:
    """The reference's gates on one per-image record."""
    return (r["raw_conf"] < low_conf and r["sr"] == r["gt"]
            and r["sr_conf"] >= high_conf)


def render_panel(lr_img, sr_img, gt, raw, raw_conf, sr_text, sr_conf
                 ) -> np.ndarray:
    """3-row report card: the ground truth, the LR image and its OCR, the
    SR image and its OCR (each image resized to 50 x 380 with Pillow's
    bicubic resample)."""
    from lpr_tpu_torch import native
    from lpr_tpu_torch.pipeline import draw

    panel = np.empty((PANEL_H, PANEL_W, 3), np.uint8)
    panel[:] = PANEL_BG
    draw.draw_text(panel, (10, 8), f"Ground Truth: {gt}", GT_COLOR, 16)

    def paste(img, y):
        draw.paste(panel, native.resize_pil_bicubic(img, (50, PANEL_W - 40)),
                   (20, y))

    paste(lr_img, 40)
    draw.draw_text(panel, (10, 96), f"OCR: {raw or '-'} (conf {raw_conf:.2f})",
                   OK_COLOR if raw == gt else BAD_COLOR, 16)
    paste(sr_img, 130)
    draw.draw_text(panel, (10, 186),
                   f"SR OCR: {sr_text or '-'} (conf {sr_conf:.2f})",
                   OK_COLOR if sr_text == gt else BAD_COLOR, 16)
    return panel


def main(argv=None) -> List[str]:
    """Run the CLI; returns the ground truths of the panels written."""
    args = parse_args(argv)
    from lpr_tpu_torch import imageio
    from lpr_tpu_torch.cli.evaluate import build_evaluator

    ev = build_evaluator(args.ocr_weights, args.sr_weights, args.device,
                         ocr_conf=args.ocr_conf, iou=args.iou)
    files = imageio.list_images(args.eval_folder)
    images, gts = [], []
    for f in files:
        img = imageio.read_rgb(os.path.join(args.eval_folder, f))
        images.append(clahe_gray(img) if args.clahe else img)
        gts.append(os.path.splitext(f)[0].upper())
    rep = ev.evaluate_arrays(images, gts)

    os.makedirs(args.out, exist_ok=True)
    found = []
    for r in rep.per_image:
        if not is_improvement(r, args.low_conf, args.high_conf):
            continue
        i = r["index"]
        # the SR image for the panel: the device batch on this image alone
        canvas, sr_in = ev._prep_host(images[i])
        _, sr = ev.run_batch(canvas[None], sr_in[None])
        sr_img = (np.clip(np.repeat(sr[0], 3, -1), 0, 1) * 255
                  ).astype(np.uint8)
        panel = render_panel(images[i], sr_img, r["gt"], r["raw"],
                             r["raw_conf"], r["sr"], r["sr_conf"])
        imageio.write_png(os.path.join(args.out, f"improved_{r['gt']}.png"),
                          panel)
        found.append(r["gt"])
        print(f"improved: {r['gt']} raw={r['raw']!r}({r['raw_conf']:.2f}) "
              f"sr={r['sr']!r}({r['sr_conf']:.2f})")
    print(f"{len(found)} convincing improvements -> {args.out}")
    return found


if __name__ == "__main__":
    main()
