"""Synthetic street frames made with numpy alone (no PIL), from a seed —
inputs for the chip check and the step profiler on a machine without the
JAX package's PIL-based renderer (tools/synth_plates.py) — and a PNG
writer in the standard library, for the file and bytes ingestion paths."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def synth_frames(n: int, hw, seed: int) -> np.ndarray:
    """(n, H, W, 3) uint8 frames: a smooth background with noise and 1-3
    plate-like panels (light rectangle, dark border, dark glyph bars)
    each, sized relative to the frame."""
    rng = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.uint8)
    for b in range(n):
        base = (60 + 50 * np.sin(xx / rng.uniform(80, 200))
                + 40 * np.cos(yy / rng.uniform(60, 150)))
        img = base[..., None] + rng.randn(h, w, 3) * 12 + rng.uniform(
            -20, 20, 3)
        for _ in range(rng.randint(1, 4)):
            pw = rng.randint(w // 14, w // 5)
            ph = int(pw * rng.uniform(0.22, 0.75))
            x1, y1 = rng.randint(0, w - pw), rng.randint(0, h - ph)
            img[y1:y1 + ph, x1:x1 + pw] = rng.uniform(200, 245)
            img[y1:y1 + ph, x1:x1 + 3] = img[y1:y1 + ph, x1 + pw - 3:x1 + pw] = 20
            img[y1:y1 + 3, x1:x1 + pw] = img[y1 + ph - 3:y1 + ph, x1:x1 + pw] = 20
            rows = 2 if ph > 0.5 * pw else 1
            gh = int(ph * (0.6 if rows == 1 else 0.35))
            for r in range(rows):
                gy = y1 + (ph - rows * gh) // (rows + 1) * (r + 1) + r * gh
                for k in range(rng.randint(5, 9)):
                    gx = x1 + pw // 12 + k * (pw - pw // 6) // 9
                    img[gy:gy + gh, gx:gx + max(2, pw // 30)] = 25
        out[b] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def png_bytes(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (8-bit truecolour, no interlace,
    filter 0 on every row), written with ``zlib`` and ``struct`` alone."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a uint8 (H, W, 3) image, got "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)   # filter byte 0, then the row
    raw[:, 1:] = img.reshape(h, 3 * w)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    """Write ``img`` (H, W, 3) uint8 RGB to ``path`` as PNG
    (:func:`png_bytes`)."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))
