"""Box geometry (counterpart of ``lpr_tpu/ops/boxes.py``)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def xywh2xyxy(b: Tensor) -> Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def clip_boxes(b: Tensor, h: float, w: float) -> Tensor:
    """Clamp xyxy boxes to the image bounds."""
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h),
                        x2.clamp(0, w), y2.clamp(0, h)], -1)


def box_iou(a: Tensor, b: Tensor) -> Tensor:
    """Pairwise IoU.  a: (..., M, 4), b: (..., N, 4) xyxy -> (..., M, N)."""
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-9)
