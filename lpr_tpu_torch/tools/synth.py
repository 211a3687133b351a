"""Synthetic street frames made with numpy alone (no PIL), from a seed —
inputs for the chip check and the step profiler on a machine without the
JAX package's PIL-based renderer (tools/synth_plates.py).  The PNG writer
of the file and bytes ingestion paths lives in :mod:`lpr_tpu_torch.imageio`
(re-exported here)."""

from __future__ import annotations

import numpy as np

from lpr_tpu_torch.imageio import png_bytes, write_png

__all__ = ["png_bytes", "synth_frames", "write_png"]


def synth_frames(n: int, hw, seed: int) -> np.ndarray:
    """(n, H, W, 3) uint8 frames: a smooth background with noise and 1-3
    plate-like panels (light rectangle, dark border, dark glyph bars)
    each, sized relative to the frame."""
    rng = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.uint8)
    for b in range(n):
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
            gh = int(ph * (0.6 if rows == 1 else 0.35))
            for r in range(rows):
                gy = y1 + (ph - rows * gh) // (rows + 1) * (r + 1) + r * gh
                for k in range(rng.randint(5, 9)):
                    gx = x1 + pw // 12 + k * (pw - pw // 6) // 9
                    img[gy:gy + gh, gx:gx + max(2, pw // 30)] = 25
        out[b] = np.clip(img, 0, 255).astype(np.uint8)
    return out
