"""Host-side datasets yielding whole numpy batches (counterpart of
``lpr_tpu/data/datasets.py``), without PIL.

- :class:`PairedImageDataset` (LPSR): LR and HR images matched by identical
  file name; LR read as RGB, HR as Pillow's ``"L"`` luma by default, both
  resized to ``hw``.
- :class:`UnpairedImageDataset` (CycleGAN): ``trainA`` indexed with
  wraparound, ``trainB`` drawn at random, in [-1, 1].

Files are read by :func:`lpr_tpu_torch.imageio.read_rgb` (by content, not
by extension) and resized by the port's copy of Pillow's bilinear resample
(:func:`lpr_tpu_torch.native.resize_pil_bilinear`), so the arrays equal the
JAX package's ``Image.open(p).convert(mode).resize(..., BILINEAR)``.
"""

from __future__ import annotations

import os
import random
from typing import Iterator, List, Tuple

import numpy as np

from lpr_tpu_torch import imageio, native

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def list_images(folder: str) -> List[str]:
    return sorted(os.path.join(folder, f) for f in os.listdir(folder)
                  if f.lower().endswith(IMG_EXTS))


def luma_u8(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) uint8 as Pillow's ``convert("L")``:
    ``(R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16``."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _resize_u8(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    if img.shape[:2] == tuple(hw):
        return img
    return native.resize_pil_bilinear(img, hw)


def load_image(path: str, hw: Tuple[int, int], mode: str = "RGB"
               ) -> np.ndarray:
    """One file -> (H, W, 3) (``"RGB"``) or (H, W, 1) (``"L"``) float32 in
    [0, 1] at ``hw``.  The port's resample takes three channels; Pillow
    resamples each channel alone, so the luma goes through it replicated
    three times and one copy is kept."""
    rgb = imageio.read_rgb(path)
    if mode == "RGB":
        out = _resize_u8(rgb, hw)
    elif mode == "L":
        out = _resize_u8(np.repeat(luma_u8(rgb)[..., None], 3, -1),
                         hw)[..., :1]
    else:
        raise ValueError(f"mode must be RGB or L, got {mode!r}")
    return out.astype(np.float32) / 255.0


class PairedImageDataset:
    """LR/HR pairs by identical file name."""

    def __init__(self, hr_dir: str, lr_dir: str,
                 hw: Tuple[int, int] = (32, 192), hr_gray: bool = True):
        self.hw = hw
        self.hr_gray = hr_gray
        names = sorted(f for f in os.listdir(lr_dir)
                       if f.lower().endswith(IMG_EXTS))
        self.pairs = [(os.path.join(lr_dir, f), os.path.join(hr_dir, f))
                      for f in names
                      if os.path.exists(os.path.join(hr_dir, f))]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i) -> Tuple[np.ndarray, np.ndarray]:
        lr_p, hr_p = self.pairs[i]
        return (load_image(lr_p, self.hw, "RGB"),
                load_image(hr_p, self.hw, "L" if self.hr_gray else "RGB"))

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = False
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = list(range(len(self)))
        if shuffle:
            random.Random(seed).shuffle(idx)
        for s in range(0, len(idx), batch_size):
            chunk = idx[s:s + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            lrs, hrs = zip(*[self[i] for i in chunk])
            yield np.stack(lrs), np.stack(hrs)


class UnpairedImageDataset:
    """CycleGAN domains A and B under ``root/{phase}A`` and ``{phase}B``:
    A by index with wraparound, B at random; output in [-1, 1]."""

    def __init__(self, root: str, hw: Tuple[int, int] = (32, 192),
                 phase: str = "train", seed: int = 0):
        self.a = list_images(os.path.join(root, f"{phase}A"))
        self.b = list_images(os.path.join(root, f"{phase}B"))
        self.hw = hw
        self.rng = random.Random(seed)

    def __len__(self):
        return max(len(self.a), len(self.b))

    def __getitem__(self, i) -> Tuple[np.ndarray, np.ndarray]:
        a = load_image(self.a[i % len(self.a)], self.hw) * 2.0 - 1.0
        b = load_image(self.b[self.rng.randrange(len(self.b))],
                       self.hw) * 2.0 - 1.0
        return a, b

    def batches(self, batch_size: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for s in range(0, len(self), batch_size):
            items = [self[i] for i in range(s, min(s + batch_size, len(self)))]
            a, b = zip(*items)
            yield np.stack(a), np.stack(b)
