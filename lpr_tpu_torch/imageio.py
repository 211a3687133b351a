"""Image files without PIL: the port's PNG reader and writer, JPEG through
the port's host decoder, and the folder listing of the evaluation tools.

- :func:`read_rgb` — a PNG or JPEG file -> (H, W, 3) uint8 RGB, as
  ``np.asarray(PIL.Image.open(path).convert("RGB"))`` gives it.  PNG is
  decoded here with ``zlib`` and numpy: 8-bit colour types 0 (gray), 2
  (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA), gray and palette also
  at 1, 2 and 4 bits, all five row filters; alpha is dropped, as
  ``convert("RGB")`` drops it.  A 16-bit or interlaced PNG raises.  JPEG
  goes through :func:`lpr_tpu_torch.native.decode_image` (libjpeg), which
  raises with g++'s message where the library does not build.
- :func:`png_bytes`, :func:`write_png` — (H, W, 3) uint8 -> an 8-bit RGB
  PNG, written with ``zlib`` and ``struct`` alone.
- :func:`list_images` — the PNG and JPEG files of a folder, sorted, as the
  JAX evaluator lists them; :func:`image_hw` — an image's size, from a
  PNG's header.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")
# channels of each PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def list_images(folder: str) -> List[str]:
    """File names in ``folder`` ending in .png, .jpg or .jpeg (any case),
    sorted."""
    return sorted(f for f in os.listdir(folder)
                  if f.lower().endswith(IMAGE_SUFFIXES))


def read_rgb(path: str) -> np.ndarray:
    """A PNG or JPEG file -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data.startswith(b"\xff\xd8"):
        from lpr_tpu_torch import native

        img = native.decode_image(data)
        if img is None:
            raise ValueError(f"{path}: the JPEG does not decode")
        return img
    raise ValueError(f"{path}: neither PNG nor JPEG")


def image_hw(path: str) -> Tuple[int, int]:
    """(height, width) of an image file: a PNG's from its header (no
    decode), any other through :func:`read_rgb`."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head.startswith(PNG_SIGNATURE) and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return int(h), int(w)
    return tuple(read_rgb(path).shape[:2])


def _chunks(data: bytes):
    i = len(PNG_SIGNATURE)
    while i + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[i:i + 8])
        yield kind, data[i + 8:i + 8 + n]
        if kind == b"IEND":
            return
        i += 12 + n
    raise ValueError("truncated PNG: no IEND chunk")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB (see the module docstring for what
    it takes)."""
    ihdr, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not a valid one")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if depth == 16 or depth not in ((1, 2, 4, 8) if ctype in (0, 3)
                                    else (8,)):
        raise ValueError(f"{depth}-bit PNG of colour type {ctype} is not "
                         f"supported")
    ch = _CHANNELS[ctype]
    row_bytes = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (row_bytes + 1):
        raise ValueError("PNG image data is shorter than its size")
    raw = raw[:h * (row_bytes + 1)].reshape(h, row_bytes + 1)
    rows = _unfilter(raw[:, 0], raw[:, 1:], max(1, ch * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        samples = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(
            -1).astype(np.uint8)
    else:
        samples = rows.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[samples.reshape(h, w)]
    if ctype in (0, 4):
        gray = samples.reshape(h, w, ch)[..., 0]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(gray[..., None], 3, -1)
    return np.ascontiguousarray(samples[..., :3])


def _unfilter(types: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: types (h,), filtered rows (h, row_bytes)
    -> the rows' bytes.  A pixel depends on its left neighbour and the two
    above it, so the anti-diagonals of the (row, pixel) grid are
    reconstructed in turn, each all at once: row y is stored shifted right
    by y + 1 pixels, which makes an anti-diagonal one column and its three
    neighbours two columns to its left, and a zero row and two zero columns
    stand in for the pixels outside the image."""
    if types.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(types.max())} is not a "
                         f"valid one")
    if not types.any():            # filter 0 on every row: the bytes as is
        return np.ascontiguousarray(filt)
    h, nb = filt.shape
    n = nb // bpp
    rows, xs = np.mgrid[1:h + 1, 0:n]
    cols = xs + rows + 1
    f = np.zeros((h + 1, n + h + 1, bpp), np.int32)
    f[rows, cols] = filt.reshape(h, n, bpp)
    s = np.zeros_like(f)
    ft = types.astype(np.intp)
    cand = np.zeros((5, h, bpp), np.int32)      # each filter's predictor
    every = np.arange(h)
    for t in range(2, n + h + 1):
        y0, y1 = max(1, t - n), min(h, t - 1)
        m = y1 - y0 + 1
        a, b, c = s[y0:y1 + 1, t - 1], s[y0 - 1:y1, t - 1], s[y0 - 1:y1, t - 2]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        cand[1, :m], cand[2, :m], cand[3, :m] = a, b, (a + b) >> 1
        cand[4, :m] = np.where((pa <= pb) & (pa <= pc), a,
                               np.where(pb <= pc, b, c))
        pred = cand[ft[y0 - 1:y1], every[:m]]
        s[y0:y1 + 1, t] = (f[y0:y1 + 1, t] + pred) & 255
    return s[rows, cols].reshape(h, nb).astype(np.uint8)


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

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    """Write ``img`` (H, W, 3) uint8 RGB to ``path`` as PNG
    (:func:`png_bytes`)."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))
