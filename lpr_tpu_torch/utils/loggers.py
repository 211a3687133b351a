"""Training loggers: CSV always; TensorBoard events when TF is present
(counterpart of ``lpr_tpu/utils/loggers.py``).

Reference: ``yolov5/utils/loggers/__init__.py:37-168`` (CSV + TensorBoard +
W&B facade).  W&B has no offline-egress equivalent here; the facade accepts
arbitrary scalar dicts so an external sink can be registered via callbacks.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict


class CsvLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._keys = None

    def log(self, metrics: Dict[str, float], step: int):
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        new = self._keys is None
        if new:
            self._keys = list(row)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._keys, extrasaction="ignore")
            if new and f.tell() == 0:
                w.writeheader()
            w.writerow(row)


class TensorBoardLogger:
    """Thin TF-summary writer; silently disabled when TF is unavailable."""

    def __init__(self, logdir: str):
        try:
            import tensorflow as tf  # noqa

            self._writer = tf.summary.create_file_writer(logdir)
            self._tf = tf
        except Exception:
            self._writer = None
            self._tf = None

    def log(self, metrics: Dict[str, float], step: int):
        if self._writer is None:
            return
        with self._writer.as_default():
            for k, v in metrics.items():
                self._tf.summary.scalar(k, float(v), step=step)
            self._writer.flush()


class Loggers:
    """Facade: fan out to CSV (+ TensorBoard when available)."""

    def __init__(self, save_dir: str, tensorboard: bool = False):
        os.makedirs(save_dir, exist_ok=True)
        self.csv = CsvLogger(os.path.join(save_dir, "results.csv"))
        self.tb = TensorBoardLogger(save_dir) if tensorboard else None
        self.t0 = time.time()

    def log(self, metrics: Dict[str, float], step: int):
        self.csv.log(metrics, step)
        if self.tb:
            self.tb.log(metrics, step)
