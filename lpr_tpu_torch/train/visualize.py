"""Per-epoch image grids of the trainers, without PIL (counterpart of
``lpr_tpu/train/visualize.py``; reference ``train/lpsr.py:48-94`` and
``train/cyclegans.py:148-183``).

Each cell is resized as Pillow's default ``resize`` does (bicubic, through
:func:`lpr_tpu_torch.native.resize_pil_bicubic`) and the titles are drawn
in the port's 5x7 bitmap font (:mod:`lpr_tpu_torch.pipeline.draw`), so a
grid equals the JAX package's everywhere but inside the title boxes.
Grids are written as PNG.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from lpr_tpu_torch import imageio, native
from lpr_tpu_torch.pipeline import draw

BACKGROUND = (24, 24, 24)
TITLE_COLOR = (200, 200, 200)
TITLE_SIZE = 10
HEADER = 20


def _to_u8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def image_grid(rows: Sequence[Sequence[np.ndarray]],
               titles: Optional[Sequence[str]] = None,
               cell_hw=(64, 384), pad: int = 6) -> np.ndarray:
    """Rows of [0, 1] images -> one (H, W, 3) uint8 grid, each cell
    resized to ``cell_hw``, a title above each column."""
    ch, cw = cell_hw
    n_rows = len(rows)
    n_cols = max(len(r) for r in rows)
    header = HEADER if titles else 0
    canvas = np.empty((n_rows * (ch + pad) + pad + header,
                       n_cols * (cw + pad) + pad, 3), np.uint8)
    canvas[:] = BACKGROUND
    for c, t in enumerate((titles or [])[:n_cols]):
        draw.draw_text(canvas, (pad + c * (cw + pad) + 4, 4), t,
                       TITLE_COLOR, TITLE_SIZE)
    for r, row in enumerate(rows):
        for c, img in enumerate(row):
            u8 = _to_u8(img)
            cell = (u8 if u8.shape[:2] == (ch, cw)
                    else native.resize_pil_bicubic(u8, (ch, cw)))
            draw.paste(canvas, cell, (pad + c * (cw + pad),
                                      header + pad + r * (ch + pad)))
    return canvas


def _save(path: str, grid: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imageio.write_png(path, grid)


def save_lpsr_epoch_grid(path: str, lr_imgs, sr_imgs, hr_imgs) -> None:
    """LR | SR | HR rows, up to four ([0, 1] inputs)."""
    rows = [[np.asarray(lr_imgs[i]), np.asarray(sr_imgs[i]),
             np.asarray(hr_imgs[i])] for i in range(min(len(lr_imgs), 4))]
    _save(path, image_grid(rows, titles=["Original LR", "Super-Resolved",
                                         "GT HR"]))


def save_cyclegan_epoch_grid(path: str, real_a, fake_b, rec_a,
                             real_b, fake_a, rec_b) -> None:
    """real_A | fake_B | rec_A over real_B | fake_A | rec_B ([-1, 1]
    inputs)."""
    def dn(x):
        return np.asarray(x) * 0.5 + 0.5

    rows = [[dn(real_a[0]), dn(fake_b[0]), dn(rec_a[0])],
            [dn(real_b[0]), dn(fake_a[0]), dn(rec_b[0])]]
    _save(path, image_grid(rows, titles=["real", "fake", "reconstructed"]))
