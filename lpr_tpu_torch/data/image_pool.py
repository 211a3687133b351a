"""CycleGAN image history pool (counterpart of
``lpr_tpu/data/image_pool.py``, reference ``my_utils/utils.py:185-212``).

Keeps up to ``pool_size`` earlier fakes; each incoming fake is stored
(pool not full), swapped with a random entry of the history (p = 0.5) or
passed through.  The choices come from Python's ``random.Random(seed)``,
as in the JAX package, so the same seed and inputs give the same outputs.
The images may be numpy arrays or tensors (kept on their device).
"""

from __future__ import annotations

import random
from typing import List

import numpy as np
import torch


class ImagePool:
    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.images: List = []
        self.rng = random.Random(seed)

    def query(self, images):
        """images (B, H, W, C), an array or a tensor.  Returns a batch of
        the same shape and kind mixing in the history."""
        if self.pool_size == 0:
            return images
        out = []
        for img in images:
            if len(self.images) < self.pool_size:
                self.images.append(img)
                out.append(img)
            elif self.rng.random() > 0.5:
                idx = self.rng.randint(0, self.pool_size - 1)
                out.append(self.images[idx])
                self.images[idx] = img
            else:
                out.append(img)
        return torch.stack(out) if torch.is_tensor(images) else np.stack(out)
