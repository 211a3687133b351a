"""Reading-order character assembly on the host (the port's own copy of
``lpr_tpu/pipeline/chars.py``): cluster detections into rows by centre-y
gaps, sort each row left to right, flatten.  Works on the fixed-shape
arrays of :mod:`lpr_tpu_torch.ops.nms`, fetched as numpy."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

OCR_CLASSES = tuple("0123456789abcdefghijklmnopqrstuvwxyz")
"""Class names of the char OCR detector."""


def reading_order(boxes: np.ndarray) -> np.ndarray:
    """Permutation putting boxes (N, 4) xyxy into reading order.  Row
    threshold = max(10, (max_cy - min_cy) / 5), as the reference."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0,), np.int64)
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    by_y = np.argsort(cy, kind="stable")
    thr = max(10.0, (cy[by_y[-1]] - cy[by_y[0]]) / 5.0)
    rows: List[List[int]] = [[by_y[0]]]
    for prev, cur in zip(by_y[:-1], by_y[1:]):
        if abs(cy[cur] - cy[prev]) > thr:
            rows.append([cur])
        else:
            rows[-1].append(cur)
    order = []
    for row in rows:
        order.extend(sorted(row, key=lambda i: cx[i]))
    return np.asarray(order, np.int64)


def detections_to_string(boxes: np.ndarray, classes: np.ndarray,
                         valid: np.ndarray,
                         names: Sequence[str] = OCR_CLASSES) -> str:
    """Fixed-shape NMS output -> plate string, uppercased."""
    idx = np.nonzero(np.asarray(valid))[0]
    if len(idx) == 0:
        return ""
    b = np.asarray(boxes)[idx]
    c = np.asarray(classes)[idx]
    return "".join(str(names[int(c[i])]).upper() for i in reading_order(b))


def detections_to_string_conf(boxes: np.ndarray, classes: np.ndarray,
                              scores: np.ndarray, valid: np.ndarray,
                              names: Sequence[str] = OCR_CLASSES
                              ) -> Tuple[str, float]:
    """:func:`detections_to_string` and the mean confidence of the valid
    characters (0.0 without any), the evaluator's confidence gate."""
    idx = np.nonzero(np.asarray(valid))[0]
    if len(idx) == 0:
        return "", 0.0
    text = detections_to_string(boxes, classes, valid, names)
    return text, float(np.asarray(scores)[idx].mean())
