"""Synthetic street frames made with numpy alone (no PIL), from a seed —
inputs for the chip check and the step profiler on a machine without the
JAX package's PIL-based renderer (tools/synth_plates.py).  The PNG writer
of the file and bytes ingestion paths lives in :mod:`lpr_tpu_torch.imageio`
(re-exported here)."""

from __future__ import annotations

import numpy as np

from lpr_tpu_torch.imageio import png_bytes, write_png

__all__ = ["png_bytes", "synth_frames", "write_png", "write_yolo_tree"]


def synth_frames(n: int, hw, seed: int, labels: bool = False):
    """(n, H, W, 3) uint8 frames: a smooth background with noise and 1-3
    plate-like panels (light rectangle, dark border, dark glyph bars)
    each, sized relative to the frame.  With ``labels``, ``(frames,
    boxes)``: for each frame a (k, 5) float32 array of its panels as YOLO
    labels [class, cx, cy, w, h] normalized, class 8 for a panel of one
    glyph row and 7 for two (the plate detector's classes); the frames are
    the same either way."""
    rng = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.uint8)
    boxes = []
    for b in range(n):
        rows_b = []
        base = (60 + 50 * np.sin(xx / rng.uniform(80, 200))
                + 40 * np.cos(yy / rng.uniform(60, 150)))
        img = base[..., None] + rng.randn(h, w, 3) * 12 + rng.uniform(
            -20, 20, 3)
        for _ in range(rng.randint(1, 4)):
            pw = rng.randint(w // 14, w // 5)
            ph = int(pw * rng.uniform(0.22, 0.75))
            x1, y1 = rng.randint(0, w - pw), rng.randint(0, h - ph)
            img[y1:y1 + ph, x1:x1 + pw] = rng.uniform(200, 245)
            img[y1:y1 + ph, x1:x1 + 3] = img[y1:y1 + ph, x1 + pw - 3:x1 + pw] = 20
            img[y1:y1 + 3, x1:x1 + pw] = img[y1 + ph - 3:y1 + ph, x1:x1 + pw] = 20
            rows = 2 if ph > 0.5 * pw else 1
            rows_b.append([8 if rows == 1 else 7, (x1 + pw / 2) / w,
                           (y1 + ph / 2) / h, pw / w, ph / h])
            gh = int(ph * (0.6 if rows == 1 else 0.35))
            for r in range(rows):
                gy = y1 + (ph - rows * gh) // (rows + 1) * (r + 1) + r * gh
                for k in range(rng.randint(5, 9)):
                    gx = x1 + pw // 12 + k * (pw - pw // 6) // 9
                    img[gy:gy + gh, gx:gx + max(2, pw // 30)] = 25
        out[b] = np.clip(img, 0, 255).astype(np.uint8)
        boxes.append(np.asarray(rows_b, np.float32).reshape(-1, 5))
    return (out, boxes) if labels else out


def write_yolo_tree(root: str, n: int, hw=(720, 1280), seed: int = 0):
    """``root/images/f00000.png``... and ``root/labels/f00000.txt``...: n
    frames of :func:`synth_frames` as PNG with their panels as YOLO labels
    (written a frame at a time, so memory stays one frame).  Returns
    (image dir, label dir)."""
    import os

    img_dir = os.path.join(root, "images")
    lbl_dir = os.path.join(root, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)
    for i in range(n):
        frames, boxes = synth_frames(1, hw, seed * 100003 + i, labels=True)
        write_png(os.path.join(img_dir, f"f{i:05d}.png"), frames[0])
        with open(os.path.join(lbl_dir, f"f{i:05d}.txt"), "w") as f:
            f.writelines(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} "
                         f"{r[4]:.6f}\n" for r in boxes[0])
    return img_dir, lbl_dir
