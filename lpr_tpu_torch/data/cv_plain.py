"""Plain numpy versions of the host library ``csrc/host_augment.cc``
(:func:`lpr_tpu_torch.native.cv_resize_linear`, :func:`~lpr_tpu_torch
.native.cv_warp_affine`, :func:`~lpr_tpu_torch.native.cv_hsv_lut`): the
same arithmetic written with numpy, for the tests.  Each follows OpenCV's
own (cv2.resize INTER_LINEAR, cv2.warpAffine INTER_LINEAR with a constant
border, RGB2HSV -> LUT -> HSV2RGB on 8 bits), as the C source describes."""

from __future__ import annotations

from typing import Tuple

import numpy as np

f32 = np.float32


def _taps(n_src: int, n_dst: int):
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(f32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(f32)).astype(f32)


def resize_linear(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)``."""
    h, w, cn = img.shape
    if (nw, nh) == (w, h):
        return img.copy()
    sx_, sy_ = 1.0 / (nw / w), 1.0 / (nh / h)
    eps = np.finfo(np.float64).eps
    if abs(sx_ - 2) < eps and abs(sy_ - 2) < eps:       # 2x: the area mean
        x = img.astype(np.int32)
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2]
                 + x[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    sx, fx = _taps(w, nw)
    fx[sx < 0] = 0
    sx[sx < 0] = 0
    hi = sx >= w - 1
    fx[hi] = 0
    sx[hi] = w - 1
    a0 = np.rint((f32(1) - fx) * f32(2048)).astype(np.int64)
    a1 = np.rint(fx * f32(2048)).astype(np.int64)
    x = img.astype(np.int64)
    rows = (x[:, sx] * a0[None, :, None]
            + x[:, np.minimum(sx + 1, w - 1)] * a1[None, :, None])
    sy, fy = _taps(h, nh)
    b0 = np.rint((f32(1) - fy) * f32(2048)).astype(np.int64)[:, None, None]
    b1 = np.rint(fy * f32(2048)).astype(np.int64)[:, None, None]
    s0 = rows[np.clip(sy, 0, h - 1)]
    s1 = rows[np.clip(sy + 1, 0, h - 1)]
    out = ((((s0 >> 4) * b0) >> 16) + (((s1 >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _invert(m) -> np.ndarray:
    M = [float(v) for v in np.asarray(m, np.float64)[:2, :3].ravel()]
    D = M[0] * M[4] - M[1] * M[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = M[4] * D, M[0] * D
    M[0], M[1], M[3], M[4] = a11, M[1] * -D, M[3] * -D, a22
    b1 = -M[0] * M[2] - M[1] * M[5]
    b2 = -M[3] * M[2] - M[4] * M[5]
    M[2], M[5] = b1, b2
    return np.asarray(M, f32)


def warp_affine(img: np.ndarray, m, dsize: Tuple[int, int],
                border: int = 114) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize=(w, h), borderValue=(border,) * 3)``
    (INTER_LINEAR) of a uint8 (H, W, 3) image."""
    M = _invert(m)
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw, cn = img.shape
    x = np.arange(w, dtype=f32)[None, :]
    y = np.arange(h, dtype=f32)[:, None]
    sx = x * M[0] + (y * M[1] + M[2])
    sy = x * M[3] + (y * M[4] + M[5])
    flx, fly = np.floor(sx), np.floor(sy)
    ix = np.clip(flx, -1e6, 1e6).astype(np.int64)
    iy = np.clip(fly, -1e6, 1e6).astype(np.int64)
    fx = (sx - flx)[..., None]
    fy = (sy - fly)[..., None]
    pad = np.full((sh + 2, sw + 2, cn), border, f32)
    pad[1:-1, 1:-1] = img

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < sh) & (xx >= 0) & (xx < sw)
        v = pad[np.clip(yy, -1, sh) + 1, np.clip(xx, -1, sw) + 1]
        return np.where(inside[..., None], v, f32(border)).astype(f32)

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = p00 + fx * (p01 - p00)
    v1 = p10 + fx * (p11 - p10)
    v = v0 + fy * (v1 - v0)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


_SDIV = np.zeros(256, np.int64)
_HDIV = np.zeros(256, np.int64)
_SDIV[1:] = np.rint((255 << 12) / (1.0 * np.arange(1, 256)))
_HDIV[1:] = np.rint((180 << 12) / (6.0 * np.arange(1, 256)))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` on 8 bits."""
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff,
                                         r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << 11)) >> 12
    h = h + np.where(h < 0, 180, 0)
    return np.stack([np.clip(h, 0, 255), s, v], -1).astype(np.uint8)


def hsv2rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` on 8 bits (float32,
    truncated)."""
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.fmod(hsv[..., 0].astype(f32) * f32(6.0 / 180.0), f32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = (h - sector.astype(f32)).astype(f32)
    bad = (sector < 0) | (sector >= 6)
    sector[bad] = 0
    h[bad] = 0
    one = f32(1)
    tab = np.stack([v, v * (one - s), v * (one - s * h),
                    v * (one - s * (one - h))], -1).astype(f32)
    idx = _SECTORS[sector]
    bgr = [np.take_along_axis(tab, idx[..., k:k + 1], -1)[..., 0]
           for k in range(3)]
    rgb = np.stack([bgr[2], bgr[1], bgr[0]], -1)
    rgb = np.where((hsv[..., 1] == 0)[..., None], v[..., None], rgb)
    return np.clip(np.floor(rgb * f32(255)), 0, 255).astype(np.uint8)


def hsv_lut(img: np.ndarray, lut_h, lut_s, lut_v) -> np.ndarray:
    """RGB2HSV, a table per channel, HSV2RGB (``augment_hsv``'s chain)."""
    hsv = rgb2hsv(img)
    out = np.stack([np.asarray(lut_h, np.uint8)[hsv[..., 0]],
                    np.asarray(lut_s, np.uint8)[hsv[..., 1]],
                    np.asarray(lut_v, np.uint8)[hsv[..., 2]]], -1)
    return hsv2rgb(out)
