"""Result plots: PR curves, confusion matrix, label statistics (the port's
own copy of ``lpr_tpu/eval/plots.py``).

Reference: ``yolov5/utils/plots.py:180-426`` (plot_pr_curve, ConfusionMatrix
.plot, plot_labels).  matplotlib when it imports; otherwise every function
returns None and draws nothing (the documented API of the JAX module, not
a device fallback).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_pr_curve(
    recall_grid: np.ndarray, precisions: Dict[str, np.ndarray],
    path: Optional[str] = None,
):
    """precisions: name -> precision values over recall_grid."""
    plt = _plt()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8, 6))
    for name, p in precisions.items():
        ax.plot(recall_grid, p, label=name, linewidth=1.5)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    ax.legend(fontsize=8)
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_confusion_matrix(
    matrix: np.ndarray, names: Sequence[str], path: Optional[str] = None,
    normalize: bool = True,
):
    plt = _plt()
    if plt is None:
        return None
    m = matrix.astype(np.float64)
    if normalize:
        m = m / np.maximum(m.sum(0, keepdims=True), 1e-9)
    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(m, cmap="Blues", vmin=0)
    labels = list(names) + ["background"]
    ax.set_xticks(range(len(labels)))
    ax.set_yticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90, fontsize=7)
    ax.set_yticklabels(labels, fontsize=7)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    fig.colorbar(im)
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_labels(labels: np.ndarray, path: Optional[str] = None):
    """Label statistics before training (reference plot_labels,
    yolov5/utils/plots.py:180-426): class histogram, xy/wh scatter, and
    2D-density correlogram panels.  labels (N,5) [cls,cx,cy,w,h]
    normalized."""
    plt = _plt()
    if plt is None:
        return None
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    axes = axes.ravel()
    axes[0].hist(labels[:, 0], bins=int(labels[:, 0].max()) + 1
                 if len(labels) else 1)
    axes[0].set_title("classes")
    if len(labels):
        axes[1].scatter(labels[:, 1], labels[:, 2], s=2, alpha=0.4)
        axes[2].scatter(labels[:, 3], labels[:, 4], s=2, alpha=0.4)
        # correlogram panels (the reference's seaborn pairplot density,
        # reduced to the two informative marginals: xy and wh)
        axes[3].hist2d(labels[:, 1], labels[:, 2], bins=40,
                       range=[[0, 1], [0, 1]], cmap="Blues")
        axes[4].hist2d(labels[:, 3], labels[:, 4], bins=40,
                       range=[[0, 1], [0, 1]], cmap="Blues")
        axes[5].hist(labels[:, 3] / np.maximum(labels[:, 4], 1e-9),
                     bins=40, range=(0, 8))
    axes[1].set_title("xy centers")
    axes[2].set_title("wh")
    axes[3].set_title("xy density")
    axes[4].set_title("wh density")
    axes[5].set_title("aspect ratio")
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig
