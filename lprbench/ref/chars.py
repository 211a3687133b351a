"""Reading-order assembly of the char detections into a plate string:
rows by gaps of the centres' y above max(10, spread / 5), each row left to
right, upper-case class names."""

from __future__ import annotations

from typing import Sequence

import numpy as np

OCR_CLASSES = "0123456789abcdefghijklmnopqrstuvwxyz"


def to_string(boxes: Sequence[np.ndarray], classes: Sequence[int]) -> str:
    if not len(boxes):
        return ""
    b = np.asarray(boxes, np.float64)
    cx = (b[:, 0] + b[:, 2]) / 2
    cy = (b[:, 1] + b[:, 3]) / 2
    by_y = np.argsort(cy, kind="stable")
    thr = max(10.0, (cy[by_y[-1]] - cy[by_y[0]]) / 5.0)
    rows = [[by_y[0]]]
    for prev, cur in zip(by_y[:-1], by_y[1:]):
        if abs(cy[cur] - cy[prev]) > thr:
            rows.append([cur])
        else:
            rows[-1].append(cur)
    order = [i for row in rows for i in sorted(row, key=lambda i: cx[i])]
    return "".join(OCR_CLASSES[int(classes[i])].upper() for i in order)
