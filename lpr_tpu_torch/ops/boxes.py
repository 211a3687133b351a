"""Box geometry (counterpart of ``lpr_tpu/ops/boxes.py``)."""

from __future__ import annotations

import math

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


def bbox_ciou(pred: Tensor, target: Tensor, eps: float = 1e-7) -> Tensor:
    """CIoU between aligned boxes in xywh (cx, cy, w, h), the YOLO box loss
    (``lpr_tpu/ops/boxes.py`` ``bbox_ciou``).  ``alpha`` carries no
    gradient, as the JAX function's ``stop_gradient``; the clamps at 0 are
    ``torch.maximum`` against a zero tensor, which splits the gradient at a
    tie as ``jnp.maximum`` does."""
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    px, py, pw, ph = pred.unbind(-1)
    tx, ty, tw, th = target.unbind(-1)
    p_x1, p_x2 = px - pw / 2, px + pw / 2
    p_y1, p_y2 = py - ph / 2, py + ph / 2
    t_x1, t_x2 = tx - tw / 2, tx + tw / 2
    t_y1, t_y2 = ty - th / 2, ty + th / 2
    iw = torch.maximum(torch.minimum(p_x2, t_x2) - torch.maximum(p_x1, t_x1),
                       zero)
    ih = torch.maximum(torch.minimum(p_y2, t_y2) - torch.maximum(p_y1, t_y1),
                       zero)
    inter = iw * ih
    union = pw * ph + tw * th - inter + eps
    iou = inter / union
    cw = torch.maximum(p_x2, t_x2) - torch.minimum(p_x1, t_x1)
    ch = torch.maximum(p_y2, t_y2) - torch.minimum(p_y1, t_y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (tx - px) ** 2 + (ty - py) ** 2
    v = (4 / math.pi ** 2) * (torch.atan(tw / (th + eps))
                              - torch.atan(pw / (ph + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)
