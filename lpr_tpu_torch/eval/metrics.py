"""Detection metrics: per-class AP, mAP@0.5, mAP@0.5:0.95, confusion matrix
(the port's own copy of ``lpr_tpu/eval/metrics.py``, numpy only).

Reference: ``yolov5/utils/metrics.py:15-342`` (ap_per_class with 101-point
interpolation, ConfusionMatrix).  Host-side numpy: metrics run once per
validation pass on small arrays; the detections that feed them are the
device NMS's fetched output.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, xyxy. a (M,4), b (N,4) -> (M,N)."""
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def match_predictions(
    pred_boxes: np.ndarray, pred_cls: np.ndarray,
    gt_boxes: np.ndarray, gt_cls: np.ndarray,
    iou_thresholds: np.ndarray,
) -> np.ndarray:
    """TP matrix (n_pred, n_thresholds): greedy one-to-one matching by IoU,
    class-consistent (the reference's process_batch in val.py semantics)."""
    n, t = len(pred_boxes), len(iou_thresholds)
    correct = np.zeros((n, t), bool)
    if n == 0 or len(gt_boxes) == 0:
        return correct
    iou = box_iou_np(gt_boxes, pred_boxes)
    cls_ok = gt_cls[:, None] == pred_cls[None, :]
    for ti, thr in enumerate(iou_thresholds):
        cand = np.argwhere((iou >= thr) & cls_ok)
        if len(cand):
            vals = iou[cand[:, 0], cand[:, 1]]
            order = vals.argsort()[::-1]
            cand = cand[order]
            used_gt, used_p = set(), set()
            for g, p in cand:
                if g in used_gt or p in used_p:
                    continue
                used_gt.add(g)
                used_p.add(p)
                correct[p, ti] = True
    return correct


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP (reference metrics.py compute_ap)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return float(np.trapezoid(np.interp(x, mrec, mpre), x))


def ap_per_class(
    tp: np.ndarray,       # (N, T) bool
    conf: np.ndarray,     # (N,)
    pred_cls: np.ndarray, # (N,)
    target_cls: np.ndarray,
    eps: float = 1e-16,
) -> Dict[str, np.ndarray]:
    """Per-class precision/recall/AP (reference metrics.py:15-78)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    classes, n_gt = np.unique(target_cls, return_counts=True)
    T = tp.shape[1] if tp.ndim == 2 else 1
    ap = np.zeros((len(classes), T))
    p = np.zeros(len(classes))
    r = np.zeros(len(classes))
    for ci, c in enumerate(classes):
        mask = pred_cls == c
        n_p = int(mask.sum())
        if n_p == 0 or n_gt[ci] == 0:
            continue
        fpc = (1 - tp[mask]).cumsum(0)
        tpc = tp[mask].cumsum(0)
        recall = tpc / (n_gt[ci] + eps)
        precision = tpc / (tpc + fpc)
        for ti in range(T):
            ap[ci, ti] = compute_ap(recall[:, ti], precision[:, ti])
        # P/R at max-F1 confidence on the 0.5-IoU curve
        f1 = 2 * precision[:, 0] * recall[:, 0] / (
            precision[:, 0] + recall[:, 0] + eps
        )
        i = int(f1.argmax())
        p[ci], r[ci] = precision[i, 0], recall[i, 0]
    return {
        "classes": classes, "ap": ap, "ap50": ap[:, 0],
        "map50": float(ap[:, 0].mean()) if len(classes) else 0.0,
        "map": float(ap.mean()) if len(classes) else 0.0,
        "precision": p, "recall": r,
        "mp": float(p.mean()) if len(classes) else 0.0,
        "mr": float(r.mean()) if len(classes) else 0.0,
    }


class DetectionEvaluator:
    """Accumulate NMS outputs + ground truths over a val set -> mAP."""

    IOUS = np.linspace(0.5, 0.95, 10)

    def __init__(self):
        self.tp: List[np.ndarray] = []
        self.conf: List[np.ndarray] = []
        self.pred_cls: List[np.ndarray] = []
        self.target_cls: List[np.ndarray] = []

    def add(self, pred_boxes, pred_conf, pred_cls, gt_boxes, gt_cls):
        pred_boxes = np.asarray(pred_boxes)
        self.tp.append(
            match_predictions(pred_boxes, np.asarray(pred_cls),
                              np.asarray(gt_boxes), np.asarray(gt_cls),
                              self.IOUS)
        )
        self.conf.append(np.asarray(pred_conf))
        self.pred_cls.append(np.asarray(pred_cls))
        self.target_cls.append(np.asarray(gt_cls))

    def compute(self) -> Dict[str, np.ndarray]:
        if not self.tp:
            return {"map50": 0.0, "map": 0.0, "mp": 0.0, "mr": 0.0}
        return ap_per_class(
            np.concatenate(self.tp), np.concatenate(self.conf),
            np.concatenate(self.pred_cls), np.concatenate(self.target_cls),
        )


class ConfusionMatrix:
    """Detection confusion matrix (reference metrics.py:119-180)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), np.int64)

    def process_batch(self, pred_boxes, pred_conf, pred_cls, gt_boxes, gt_cls):
        keep = np.asarray(pred_conf) > self.conf
        pred_boxes = np.asarray(pred_boxes)[keep]
        pred_cls = np.asarray(pred_cls)[keep].astype(int)
        gt_cls = np.asarray(gt_cls).astype(int)
        if len(gt_boxes) and len(pred_boxes):
            iou = box_iou_np(np.asarray(gt_boxes), pred_boxes)
            matches = np.argwhere(iou > self.iou_thres)
            matched_gt, matched_p = set(), set()
            vals = iou[matches[:, 0], matches[:, 1]] if len(matches) else []
            for idx in np.argsort(vals)[::-1] if len(matches) else []:
                g, p = matches[idx]
                if g in matched_gt or p in matched_p:
                    continue
                matched_gt.add(g)
                matched_p.add(p)
                self.matrix[pred_cls[p], gt_cls[g]] += 1
            for g in range(len(gt_boxes)):
                if g not in matched_gt:
                    self.matrix[self.nc, gt_cls[g]] += 1  # missed (bg FN)
            for p in range(len(pred_boxes)):
                if p not in matched_p:
                    self.matrix[pred_cls[p], self.nc] += 1  # false positive
        elif len(gt_boxes):
            for c in gt_cls:
                self.matrix[self.nc, c] += 1
        elif len(pred_boxes):
            for c in pred_cls:
                self.matrix[c, self.nc] += 1
