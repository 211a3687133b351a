"""Hyperparameter evolution — genetic search over training hyps
(counterpart of ``lpr_tpu/utils/evolve.py``; the standard library only).

Reference: ``yolov5/train.py:538-620`` (--evolve): mutate the best previous
hyp vector with per-gene gain/bounds metadata, train briefly, keep by
fitness.  Host-side orchestration; the short-train callable is injected.
The char OCR checkpoint carries evolved hyps produced by exactly this loop
upstream (SURVEY.md §2.3).
"""

from __future__ import annotations

import csv
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

# gene: (mutation gain, lower bound, upper bound) — reference meta table
META: Dict[str, Tuple[float, float, float]] = {
    "lr0": (1.0, 1e-5, 0.1),
    "lrf": (1.0, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1.0, 0.0, 0.001),
    "warmup_epochs": (1.0, 0.0, 5.0),
    "warmup_momentum": (1.0, 0.0, 0.95),
    "warmup_bias_lr": (1.0, 0.0, 0.2),
    "box": (1.0, 0.02, 0.2),
    "cls": (1.0, 0.2, 4.0),
    "cls_pw": (1.0, 0.5, 2.0),
    "obj": (1.0, 0.2, 4.0),
    "obj_pw": (1.0, 0.5, 2.0),
    "anchor_t": (1.0, 2.0, 8.0),
    "fl_gamma": (0.0, 0.0, 2.0),
    "hsv_h": (1.0, 0.0, 0.1),
    "hsv_s": (1.0, 0.0, 0.9),
    "hsv_v": (1.0, 0.0, 0.9),
    "degrees": (1.0, 0.0, 45.0),
    "translate": (1.0, 0.0, 0.9),
    "scale": (1.0, 0.0, 0.9),
    "shear": (1.0, 0.0, 10.0),
    "perspective": (0.0, 0.0, 0.001),
    "flipud": (1.0, 0.0, 1.0),
    "fliplr": (0.0, 0.0, 1.0),
    "mosaic": (1.0, 0.0, 1.0),
    "mixup": (1.0, 0.0, 1.0),
    "copy_paste": (1.0, 0.0, 1.0),
}


def mutate(hyp: Dict[str, float], rng: random.Random,
           mp: float = 0.8, sigma: float = 0.2) -> Dict[str, float]:
    """Mutate ~80%% of genes with multiplicative noise, clip to bounds
    (reference train.py:585-599)."""
    out = dict(hyp)
    keys = [k for k in hyp if k in META and META[k][0] > 0]
    while True:
        factors = {
            k: (1.0 + rng.gauss(0, 1) * sigma * META[k][0])
            if rng.random() < mp else 1.0
            for k in keys
        }
        if any(abs(v - 1.0) > 1e-9 for v in factors.values()):
            break
    for k in keys:
        lo, hi = META[k][1], META[k][2]
        out[k] = min(max(hyp[k] * factors[k], lo), hi)
    return out


def evolve(
    base_hyp: Dict[str, float],
    train_and_eval: Callable[[Dict[str, float]], float],
    generations: int = 30,
    seed: int = 0,
    log_path: Optional[str] = None,
) -> Tuple[Dict[str, float], float]:
    """Run GA: each generation mutates the best-so-far hyp, trains briefly
    via ``train_and_eval`` (returns fitness), keeps improvements."""
    rng = random.Random(seed)
    if log_path and os.path.exists(log_path):
        # rotate, never append: appending a fresh GA run onto an old CSV
        # silently mixes generations from different runs and can leave
        # hyp_evolve.yaml inconsistent with the log
        os.replace(log_path, log_path + ".prev")
    best_hyp, best_fit = dict(base_hyp), train_and_eval(base_hyp)
    history: List[Tuple[float, Dict[str, float]]] = [(best_fit, best_hyp)]
    for gen in range(generations):
        cand = mutate(best_hyp, rng)
        fit = train_and_eval(cand)
        history.append((fit, cand))
        if fit > best_fit:
            best_fit, best_hyp = fit, cand
        if log_path:
            exists = os.path.exists(log_path)
            with open(log_path, "a", newline="") as f:
                w = csv.writer(f)
                if not exists:
                    w.writerow(["gen", "fitness"] + sorted(cand))
                w.writerow([gen, fit] + [cand[k] for k in sorted(cand)])
    return best_hyp, best_fit
