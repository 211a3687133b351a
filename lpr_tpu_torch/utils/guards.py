"""Failure detection for long training runs (counterpart of
``lpr_tpu/utils/guards.py``).

- :func:`all_finite` — one device-side NaN/Inf check over many tensors.
- :class:`StepGuard` — skip/halt policy on non-finite losses, with
  consecutive-failure escalation.
- :func:`auto_resume_latest` — the most recent checkpoint in a run dir
  (the reference's ``--resume`` auto-find, ``train.py:507-512``).
"""

from __future__ import annotations

import glob
import math
import os
from typing import Iterable, Optional

import torch


def all_finite(tensors: Iterable) -> torch.Tensor:
    """0-d bool tensor: every floating-point tensor of ``tensors`` is
    finite (others and None are skipped; True when none is left)."""
    flags = [torch.isfinite(t).all() for t in tensors
             if torch.is_tensor(t) and t.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


class StepGuard:
    """Skip steps with non-finite loss; halt after ``max_consecutive``."""

    def __init__(self, max_consecutive: int = 10):
        self.max_consecutive = max_consecutive
        self.bad_streak = 0
        self.total_skipped = 0

    def check(self, loss: float) -> bool:
        """True if the step is healthy; raises after too many bad steps."""
        if math.isfinite(float(loss)):
            self.bad_streak = 0
            return True
        self.bad_streak += 1
        self.total_skipped += 1
        if self.bad_streak >= self.max_consecutive:
            raise FloatingPointError(
                f"{self.bad_streak} consecutive non-finite losses "
                f"({self.total_skipped} total) — halting training")
        return False


def auto_resume_latest(run_dir: str, pattern: str = "*.npz"
                       ) -> Optional[str]:
    """Most recently modified checkpoint under run_dir, or None."""
    paths = glob.glob(os.path.join(run_dir, "**", pattern), recursive=True)
    if not paths:
        return None
    return max(paths, key=os.path.getmtime)
