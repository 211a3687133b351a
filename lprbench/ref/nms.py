"""Plain non-maximum suppression with the served pipeline's semantics,
one image at a time: score = objectness x class probability for every
(candidate, class) pair (multi-label); pairs above ``conf`` ranked, the
first ``pre_topk`` kept; boxes narrower or lower than 2 px dropped; greedy
class-agnostic suppression at IoU above ``iou``; at most ``max_det``
kept, best first.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

MIN_WH, MAX_WH = 2.0, 7680.0


def iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two xyxy boxes."""
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    area = (max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
            + max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1]))
    return inter / max(area - inter, 1e-9)


def nms(xywh: np.ndarray, obj: np.ndarray, cls: np.ndarray, conf: float,
        iou_thres: float, max_det: int, pre_topk: int,
        class_ids: Optional[Sequence[int]] = None) -> List[dict]:
    """One image's candidates xywh (N, 4) px, obj (N,), cls (N, nc) ->
    kept detections as dicts (box xyxy, score, cls), best first."""
    xywh = np.asarray(xywh, np.float64)
    cols = (np.arange(cls.shape[1]) if class_ids is None
            else np.asarray(class_ids))
    scores = np.asarray(obj, np.float64)[:, None] * np.asarray(
        cls, np.float64)[:, cols]
    flat = scores.reshape(-1)
    order = np.argsort(-flat, kind="stable")[:pre_topk]
    cands = []
    for k in order:
        s = flat[k]
        if not s > conf:
            break
        i, c = divmod(int(k), len(cols))
        x, y, w, h = xywh[i]
        if not (MIN_WH <= w <= MAX_WH and MIN_WH <= h <= MAX_WH):
            continue
        cands.append({"box": np.array([x - w / 2, y - h / 2, x + w / 2,
                                       y + h / 2]),
                      "score": float(s), "cls": int(cols[c])})
    kept: List[dict] = []
    for d in cands:
        if all(iou(d["box"], k["box"]) <= iou_thres for k in kept):
            kept.append(d)
    return kept[:max_det]
