"""Frame annotation and the per-frame detail panel (counterpart of
``lpr_tpu/pipeline/annotate.py``), in numpy: plate boxes, the OCR and
SR-OCR strings and an FPS counter on a frame, and the SR crops beside
both strings in a panel.  Colours, positions and sizes are the JAX
module's; text is the port's bitmap font (:mod:`lpr_tpu_torch.pipeline.draw`)
where the JAX module renders DejaVu TrueType with PIL.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from lpr_tpu_torch import native
from lpr_tpu_torch.pipeline import draw

COLORS = [(0, 255, 128), (0, 215, 255), (255, 128, 0)]
FPS_COLOR = (144, 238, 144)
PANEL_BG = (30, 30, 30)
PANEL_TITLE = (173, 216, 230)
PANEL_OCR = (200, 200, 200)

# (x, y), text, point size, colour
Label = Tuple[Tuple[int, int], str, int, Tuple[int, int, int]]


def frame_labels(frame_hw: Tuple[int, int], plates: List[Dict],
                 fps: Optional[float] = None) -> List[Label]:
    """The text :func:`annotate_frame` draws: for each of the first three
    plates its SR string (or raw, or "?") above the box and its raw string
    and score below it; the FPS counter top left."""
    h = frame_hw[0]
    fs = max(14, h // 40)
    out: List[Label] = []
    for i, p in enumerate(plates[:3]):
        color = COLORS[i % len(COLORS)]
        x1, y1, x2, y2 = [int(v) for v in p["box"]]
        label = f"#{i+1} {p.get('text_sr') or p.get('text') or '?'}"
        out.append(((x1, max(y1 - fs - 2, 0)), label, fs, color))
        sub = f"raw:{p.get('text','')} conf:{p.get('score',0):.2f}"
        out.append(((x1, min(y2 + 2, h - fs)), sub, max(10, fs * 2 // 3),
                    color))
    if fps is not None:
        out.append(((8, 8), f"FPS: {fps:.1f}", fs, FPS_COLOR))
    return out


def annotate_frame(frame: np.ndarray, plates: List[Dict],
                   fps: Optional[float] = None) -> np.ndarray:
    """frame: (H, W, 3) uint8 RGB; plates: recognizer output dicts.  A new
    annotated frame: each of the first three plates' box, outlined inward
    ``max(2, H // 360)`` pixels wide, and :func:`frame_labels`."""
    img = np.array(frame, np.uint8, copy=True)
    h = frame.shape[0]
    for i, p in enumerate(plates[:3]):
        draw.draw_rect(img, [int(v) for v in p["box"]],
                       COLORS[i % len(COLORS)], width=max(2, h // 360))
    for xy, text, size, color in frame_labels(frame.shape[:2], plates, fps):
        draw.draw_text(img, xy, text, color, size)
    return img


def _crop_u8(sr) -> np.ndarray:
    arr = np.asarray(sr)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, -1)
    return (np.clip(arr, 0, 1) * 255).astype(np.uint8)


def side_panel(plates: List[Dict], panel_hw=(300, 900)) -> np.ndarray:
    """Detail panel: per plate (at most three, each in a slot of the
    width) its score, its SR crop resized to (40, slot - 20) with Pillow's
    bicubic resample, and both OCR strings."""
    ph, pw = panel_hw
    img = np.empty((ph, pw, 3), np.uint8)
    img[:] = PANEL_BG
    slot_w = pw // max(len(plates), 1) if plates else pw
    for i, p in enumerate(plates[:3]):
        x0 = i * slot_w + 10
        y = 10
        color = COLORS[i % len(COLORS)]
        draw.draw_text(img, (x0, y),
                       f"Plate #{i+1} conf {p.get('score', 0):.2f}",
                       PANEL_TITLE, 16)
        y += 24
        if p.get("sr") is not None:
            draw.paste(img, native.resize_pil_bicubic(
                _crop_u8(p["sr"]), (40, slot_w - 20)), (x0, y))
            y += 48
        draw.draw_text(img, (x0, y), f"OCR:    {p.get('text','')}",
                       PANEL_OCR, 16)
        y += 22
        draw.draw_text(img, (x0, y), f"SR OCR: {p.get('text_sr','')}",
                       color, 16)
    return img
