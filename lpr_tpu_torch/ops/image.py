"""Device-side image ops (counterpart of ``lpr_tpu/ops/image.py``): resize,
letterbox, oriented crop sampling and skew estimation.

The JAX functions work on one image and are ``vmap``-ed by the pipeline;
here the batch dimensions are written out.  Plate-level functions take
frames ``(B, H, W, C)``, boxes ``(B, P, 4)`` and angles ``(B, P)``, and
return ``(B, P, ...)``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def rgb_to_gray(x: Tensor) -> Tensor:
    """ITU-R BT.601 luma (OpenCV convention), (..., 3) -> (...)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return x @ w


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(..., "linear")`` along one
    axis: a triangle kernel widened by the down-scale factor (antialiasing),
    each row normalised to sum 1 (``jax._src.image.scale``
    ``compute_weight_mat`` with translation 0)."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return np.ascontiguousarray(w.T.astype(np.float32))


def resize_bilinear(x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Bilinear resize of (..., H, W, C) with ``jax.image.resize``'s
    ``"linear"`` semantics (antialiased when shrinking)."""
    h, w = int(x.shape[-3]), int(x.shape[-2])
    oh, ow = out_hw
    if oh != h:
        ry = torch.from_numpy(resize_weights(h, oh)).to(x.device, x.dtype)
        x = torch.einsum("oh,...hwc->...owc", ry, x)
    if ow != w:
        rx = torch.from_numpy(resize_weights(w, ow)).to(x.device, x.dtype)
        x = torch.einsum("pw,...owc->...opc", rx, x)
    return x


def letterbox_geom(h: int, w: int, out_hw: Tuple[int, int],
                   scaleup: bool = True
                   ) -> Tuple[float, Tuple[int, int], Tuple[int, int]]:
    """Letterbox geometry only: (gain, (nh, nw), (pad_left, pad_top))."""
    oh, ow = out_hw
    gain = min(oh / h, ow / w)
    if not scaleup:
        gain = min(gain, 1.0)
    nh, nw = int(round(h * gain)), int(round(w * gain))
    return gain, (nh, nw), ((ow - nw) // 2, (oh - nh) // 2)


def letterbox(x: Tensor, out_hw: Tuple[int, int],
              fill: float = 114.0 / 255.0, scaleup: bool = True
              ) -> Tuple[Tensor, float, Tensor]:
    """Aspect-preserving resize + centre pad of a (B, H, W, C) float batch.

    Returns (out (B, oh, ow, C), gain, pad (2,) float32 = (pad_x, pad_y))."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    gain, (nh, nw), (pad_left, pad_top) = letterbox_geom(h, w, out_hw,
                                                         scaleup)
    resized = x if (nh, nw) == (h, w) else resize_bilinear(x, (nh, nw))
    out = F.pad(resized, (0, 0, pad_left, ow - nw - pad_left,
                          pad_top, oh - nh - pad_top), value=fill)
    pad = torch.tensor([pad_left, pad_top], dtype=torch.float32,
                       device=x.device)
    return out, float(gain), pad


def sample_bilinear(img: Tensor, ys: Tensor, xs: Tensor) -> Tensor:
    """Bilinear samples of frames img (B, H, W, C) at fractional coords
    ys/xs (B, ...) with border replicate.  Returns (B, ..., C)."""
    B, H, W, C = img.shape
    ys = ys.clamp(0.0, H - 1.0)
    xs = xs.clamp(0.0, W - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    flat = img.reshape(B, H * W, C)
    shape = ys.shape

    def at(yi, xi):
        idx = (yi.long() * W + xi.long()).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(*shape, C)

    v00, v01 = at(y0, x0), at(y0, x1)
    v10, v11 = at(y1, x0), at(y1, x1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _box_frame_grid(box: Tensor, out_hw, v_range, square):
    """Shared crop geometry: the box-relative offsets (du, dv) of every
    output pixel, (B, P, oh, ow) each, plus centre and clamped size."""
    oh, ow = out_hw
    x1, y1, x2, y2 = box.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    v0, v1 = v_range
    dev = box.device
    u = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow - 0.5
    v = v0 + (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5
              ) / oh * (v1 - v0)
    uu, vv = u[None, :], v[:, None]   # broadcast to (oh, ow)
    if square:
        side = torch.maximum(bw, bh)[..., None, None]
        du, dv = uu * side, vv * side
    else:
        du, dv = uu * bw[..., None, None], vv * bh[..., None, None]
    return cx, cy, bw, bh, du, dv


def crop_rotated(img: Tensor, box: Tensor, angle: Tensor,
                 out_hw: Tuple[int, int],
                 v_range: Tuple[float, float] = (-0.5, 0.5),
                 mask_outside: bool = False, square: bool = False) -> Tensor:
    """Sample each box of each frame under a rotation about the box centre
    (the gather-based reference sampler).  img (B, H, W, C), box (B, P, 4)
    xyxy px, angle (B, P) radians.  Returns (B, P, oh, ow, C)."""
    cx, cy, bw, bh, du, dv = _box_frame_grid(box, out_hw, v_range, square)
    ca, sa = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
    xs = cx[..., None, None] + du * ca - dv * sa - 0.5
    ys = cy[..., None, None] + du * sa + dv * ca - 0.5
    out = sample_bilinear(img, ys, xs)
    if mask_outside:
        v0, v1 = v_range
        bw_, bh_ = bw[..., None, None], bh[..., None, None]
        inside = ((du.abs() <= bw_ / 2) & (dv >= bh_ * v0)
                  & (dv <= bh_ * v1))
        out = out * inside[..., None].to(out.dtype)
    return out


def sobel_gradients(gray: Tensor) -> Tuple[Tensor, Tensor]:
    """3x3 Sobel gx, gy of (..., H, W) images (replicate border)."""
    lead, (H, W) = gray.shape[:-2], gray.shape[-2:]
    g = F.pad(gray.reshape(-1, 1, H, W), (1, 1, 1, 1), mode="replicate")
    g = g.reshape(*lead, H + 2, W + 2)
    gx = ((g[..., :-2, 2:] + 2 * g[..., 1:-1, 2:] + g[..., 2:, 2:])
          - (g[..., :-2, :-2] + 2 * g[..., 1:-1, :-2] + g[..., 2:, :-2]))
    gy = ((g[..., 2:, :-2] + 2 * g[..., 2:, 1:-1] + g[..., 2:, 2:])
          - (g[..., :-2, :-2] + 2 * g[..., :-2, 1:-1] + g[..., :-2, 2:]))
    return gx, gy


def estimate_skew_angle(gray: Tensor, max_abs_deg: float = 45.0,
                        pixel_aspect=1.0) -> Tensor:
    """Dominant near-horizontal edge orientation via the structure tensor,
    per image of ``gray`` (..., H, W); returns the straightening rotation
    (radians) clamped to +-``max_abs_deg``, shape (...)."""
    gx, gy = sobel_gradients(gray)
    j_xy = (2.0 * gx * gy).mean(dim=(-2, -1))
    j_dd = (gx * gx - gy * gy).mean(dim=(-2, -1))
    theta = 0.5 * torch.atan2(j_xy, j_dd)
    tilt = theta - math.pi / 2
    tilt = torch.where(tilt <= -math.pi / 2, tilt + math.pi, tilt)
    tilt = torch.where(tilt > math.pi / 2, tilt - math.pi, tilt)
    tilt = torch.atan(torch.tan(tilt) / pixel_aspect)
    lim = math.radians(max_abs_deg)
    return tilt.clamp(-lim, lim)
