"""AutoAnchor: anchor-fit check + k-means/genetic anchor evolution
(counterpart of ``lpr_tpu/utils/autoanchor.py``; numpy, and scipy where it
imports).

Reference: ``yolov5/utils/autoanchor.py:28-165`` (check_anchors computes the
best-possible-recall metric and re-evolves anchors when BPR < 0.98;
kmean_anchors runs whitened k-means then a mutation-based genetic refinement
maximizing the anchor fitness).  The shipped char OCR model was trained with
evolved anchors (``anchors: 2`` in its yaml -> the (1,2,2) buffer in
char.pt).

Host-side numpy utility (runs once before training).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def anchor_metric(wh: np.ndarray, anchors: np.ndarray, thr: float = 4.0):
    """Per-target best anchor ratio metric (autoanchor.py:38-44).

    wh: (N, 2) label sizes (px), anchors: (A, 2).
    Returns (bpr, aat): best-possible recall and anchors-above-threshold.
    """
    r = wh[:, None, :] / anchors[None, :, :]
    x = np.minimum(r, 1.0 / r).min(2)  # (N, A) ratio metric
    best = x.max(1)
    aat = (x > 1.0 / thr).sum(1).mean()
    bpr = (best > 1.0 / thr).mean()
    return float(bpr), float(aat)


def _fitness(wh: np.ndarray, anchors: np.ndarray, thr: float) -> float:
    r = wh[:, None, :] / anchors[None, :, :]
    x = np.minimum(r, 1.0 / r).min(2)
    best = x.max(1)
    return float((best * (best > 1.0 / thr)).mean())


def kmeans_anchors(
    wh: np.ndarray,
    n: int = 9,
    thr: float = 4.0,
    gen: int = 1000,
    seed: int = 0,
    verbose: bool = False,
) -> np.ndarray:
    """Evolve ``n`` anchors from label sizes (autoanchor.py:65-165).

    wh: (N, 2) in pixels at training resolution.  Returns (n, 2) sorted by
    area.
    """
    rng = np.random.RandomState(seed)
    wh = wh[(wh >= 2.0).any(1)]  # filter tiny
    if len(wh) < n:
        reps = int(np.ceil(n / max(len(wh), 1)))
        wh = np.tile(wh, (reps, 1))

    # whitened k-means (scipy when available, plain Lloyd otherwise)
    std = wh.std(0) + 1e-8
    try:
        from scipy.cluster.vq import kmeans

        k, _ = kmeans(wh / std, n, iter=30, seed=seed)
        if len(k) != n:
            raise ValueError
        anchors = k * std
    except Exception:
        idx = rng.choice(len(wh), n, replace=False)
        anchors = wh[idx].astype(np.float64)
        for _ in range(30):
            d = ((wh[:, None, :] - anchors[None]) ** 2).sum(-1)
            assign = d.argmin(1)
            for j in range(n):
                pts = wh[assign == j]
                if len(pts):
                    anchors[j] = pts.mean(0)

    # genetic evolution: mutate, keep improvements (autoanchor.py:143-160)
    f = _fitness(wh, anchors, thr)
    shape = anchors.shape
    mp, s = 0.9, 0.1
    for g in range(gen):
        v = np.ones(shape)
        while (v == 1).all():
            v = ((rng.random(shape) < mp) * rng.random()
                 * rng.randn(*shape) * s + 1).clip(0.3, 3.0)
        cand = (anchors * v).clip(2.0, None)
        fc = _fitness(wh, cand, thr)
        if fc > f:
            f, anchors = fc, cand
            if verbose:
                print(f"gen {g}: fitness {f:.4f}")
    return anchors[np.argsort(anchors.prod(1))].astype(np.float32)


def check_anchors(
    wh: np.ndarray, anchors: np.ndarray, thr: float = 4.0,
    bpr_thresh: float = 0.98, imgsz: Optional[int] = None,
) -> Tuple[np.ndarray, bool]:
    """Re-evolve anchors when best-possible recall is poor
    (autoanchor.py:28-62).  Returns (anchors, evolved?)."""
    bpr, aat = anchor_metric(wh, anchors.reshape(-1, 2), thr)
    if bpr >= bpr_thresh:
        return anchors, False
    n = int(np.prod(anchors.shape[:-1]))
    new = kmeans_anchors(wh, n, thr)
    if _fitness(wh, new, thr) > _fitness(wh, anchors.reshape(-1, 2), thr):
        return new.reshape(anchors.shape), True
    return anchors, False
