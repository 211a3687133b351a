"""Plain image geometry of the served pipeline, float32, written with
two-tap gathers where the program multiplies interpolation matrices:

- the letterbox: ``jax.image.resize``'s antialiased linear resize, then a
  centred zero pad;
- the plate crops: an axis-aligned tile around each box, sized for a
  rotation up to 15 degrees and resampled to 64 x 256, then a two-pass
  (Catmull-Smith) affine warp of that tile, each pass a bilinear lerp
  along one axis with border replicate;
- the skew estimate: the structure tensor of a 32 x 96 grey crop, its
  near-horizontal edge direction corrected for the crop's pixel aspect;
- the OCR canvases: aspect-preserving resize into 128 x 128, centred, black.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
MAX_DESKEW_DEG = 15.0
GRAY = (0.299, 0.587, 0.114)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(..., "linear")`` along
    one axis: a triangle kernel widened by the down-scale factor, each row
    normalised to sum 1."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(total != 0, w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0.0).T)


def resize(x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Resize (..., H, W, C) with :func:`resize_weights` on each axis."""
    h, w = int(x.shape[-3]), int(x.shape[-2])
    oh, ow = out_hw
    if oh != h:
        ry = torch.from_numpy(resize_weights(h, oh)).to(x.device, x.dtype)
        x = torch.einsum("oh,...hwc->...owc", ry, x)
    if ow != w:
        rx = torch.from_numpy(resize_weights(w, ow)).to(x.device, x.dtype)
        x = torch.einsum("pw,...owc->...opc", rx, x)
    return x


def letterbox_geom(h: int, w: int, out_hw):
    """(gain, (nh, nw), (pad_left, pad_top)) of the centred letterbox."""
    oh, ow = out_hw
    gain = min(oh / h, ow / w)
    nh, nw = int(round(h * gain)), int(round(w * gain))
    return gain, (nh, nw), ((ow - nw) // 2, (oh - nh) // 2)


def letterbox(x: Tensor, out_hw) -> Tuple[Tensor, float, Tuple[int, int]]:
    """(B, H, W, C) in [0, 1] -> (letterboxed, gain, (pad_x, pad_y))."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    gain, (nh, nw), (left, top) = letterbox_geom(h, w, out_hw)
    y = x if (nh, nw) == (h, w) else resize(x, (nh, nw))
    y = F.pad(y, (0, 0, left, ow - nw - left, top, oh - nh - top))
    return y, gain, (left, top)


def lerp(x: Tensor, pos: Tensor, axis: int) -> Tensor:
    """Bilinear samples of ``x`` along ``axis`` at fractional positions
    ``pos``, clipped to the axis (border replicate): two taps each.
    ``pos`` has ``x``'s shape with ``axis`` replaced by the sample count
    (broadcast over the other axes where its size is 1)."""
    n = x.shape[axis]
    pos = pos.clamp(0.0, n - 1.0)
    i0 = torch.floor(pos)
    f = pos - i0
    i0 = i0.long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    shape = list(x.shape)
    shape[axis] = pos.shape[axis]
    i0, i1, f = (t.expand(shape) for t in (i0, i1, f))
    return (x.gather(axis, i0) * (1.0 - f) + x.gather(axis, i1) * f)


def plate_tile(frames: Tensor, boxes: Tensor, tile_hw=(64, 256)):
    """Tiles (B, P, th, tw, C) around each box of frames (B, H, W, C) and
    the tile geometry (cx, cy, su, sv), each (B, P)."""
    th, tw = tile_hw
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    slack = math.tan(math.radians(MAX_DESKEW_DEG))
    side = torch.maximum(bw, bh)
    ew = 1.05 * side + slack * bh
    eh = 1.05 * bh + slack * side
    dev = frames.device
    ys = (cy[..., None] - eh[..., None] / 2
          + (torch.arange(th, device=dev) + 0.5) * (eh[..., None] / th) - 0.5)
    xs = (cx[..., None] - ew[..., None] / 2
          + (torch.arange(tw, device=dev) + 0.5) * (ew[..., None] / tw) - 0.5)
    B, H, W, C = frames.shape
    P = boxes.shape[1]
    f = frames[:, None].expand(B, P, H, W, C)
    rows = lerp(f, ys[:, :, :, None, None], 2)             # (B, P, th, W, C)
    tile = lerp(rows, xs[:, :, None, :, None], 3)          # (B, P, th, tw, C)
    return tile, (cx, cy, tw / ew, th / eh)


def crop(tile: Tensor, geom, boxes: Tensor, angle: Tensor, out_hw,
         v_range=(-0.5, 0.5), mask_outside: bool = False,
         square: bool = False) -> Tensor:
    """The rotated crop (B, P, oh, ow, C) of each box from its tile: the
    output pixel (i, j) samples the frame at the box centre plus the
    rotated offset (du, dv), through the tile, in two passes (rows, then
    columns) of an affine warp."""
    cx_t, cy_t, su, sv = geom
    th, tw = int(tile.shape[-3]), int(tile.shape[-2])
    oh, ow = out_hw
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    v0, v1 = v_range
    if square:
        w_span = h_span = torch.maximum(bw, bh)
    else:
        w_span, h_span = bw, bh
    ca, sa = torch.cos(angle), torch.sin(angle)

    def src_uv(i, j):
        du = ((j + 0.5) / ow - 0.5) * w_span
        dv = (v0 + (i + 0.5) / oh * (v1 - v0)) * h_span
        xf = cx + du * ca - dv * sa - 0.5
        yf = cy + du * sa + dv * ca - 0.5
        return ((xf - (cx_t - 0.5)) * su + (tw - 1) / 2,
                (yf - (cy_t - 0.5)) * sv + (th - 1) / 2)

    tu, tv = src_uv(0.0, 0.0)
    u01, v01 = src_uv(0.0, 1.0)
    u10, v10 = src_uv(1.0, 0.0)
    a, c = (u01 - tu)[..., None, None], (v01 - tv)[..., None, None]
    b, d = (u10 - tu)[..., None, None], (v10 - tv)[..., None, None]
    tu, tv = tu[..., None, None], tv[..., None, None]
    d = torch.where(d.abs() < 1e-3,
                    torch.sign(d) * 1e-3 + (d == 0).to(d.dtype) * 1e-3, d)
    dev = tile.device
    j_idx = torch.arange(ow, dtype=torch.float32, device=dev)
    r_idx = torch.arange(th, dtype=torch.float32, device=dev)
    i_idx = torch.arange(oh, dtype=torch.float32, device=dev)
    # pass 1: each tile row r sampled along the tile's width at (r, j)
    u1 = (j_idx[None, :] * (a - b * c / d) + r_idx[:, None] * (b / d)
          + (tu - b * tv / d))                            # (B, P, th, ow)
    f1 = lerp(tile, u1[..., None], 3)                     # (B, P, th, ow, C)
    # pass 2: each output column j sampled along the tile's height at i
    v2 = (c * j_idx[None, :] + d * i_idx[:, None] + tv)   # (B, P, oh, ow)
    out = lerp(f1, v2[..., None], 2)                      # (B, P, oh, ow, C)
    if mask_outside:
        jj = (j_idx + 0.5) / ow - 0.5
        ii = v0 + (i_idx + 0.5) / oh * (v1 - v0)
        du = jj[None, :] * w_span[..., None, None]
        dv = ii[:, None] * h_span[..., None, None]
        bw_, bh_ = bw[..., None, None], bh[..., None, None]
        inside = ((du.abs() <= bw_ / 2) & (dv >= bh_ * -0.5)
                  & (dv <= bh_ * 0.5))
        out = out * inside[..., None].to(out.dtype)
    return out


def gray(x: Tensor) -> Tensor:
    return x @ torch.tensor(GRAY, dtype=x.dtype, device=x.device)


def structure_theta(g: Tensor) -> Tensor:
    """The structure tensor's orientation (radians, half the angle of
    ``atan2(j_xy, j_dd)``) of grey crops (..., H, W), from 3 x 3 Sobel
    gradients with a replicate border."""
    lead, (H, W) = g.shape[:-2], g.shape[-2:]
    p = F.pad(g.reshape(-1, 1, H, W), (1, 1, 1, 1), mode="replicate")
    p = p.reshape(*lead, H + 2, W + 2)
    gx = ((p[..., :-2, 2:] + 2 * p[..., 1:-1, 2:] + p[..., 2:, 2:])
          - (p[..., :-2, :-2] + 2 * p[..., 1:-1, :-2] + p[..., 2:, :-2]))
    gy = ((p[..., 2:, :-2] + 2 * p[..., 2:, 1:-1] + p[..., 2:, 2:])
          - (p[..., :-2, :-2] + 2 * p[..., :-2, 1:-1] + p[..., :-2, 2:]))
    j_xy = (2.0 * gx * gy).mean(dim=(-2, -1))
    j_dd = (gx * gx - gy * gy).mean(dim=(-2, -1))
    return 0.5 * torch.atan2(j_xy, j_dd)


def skew_angle(theta: Tensor, max_abs_deg: float, pixel_aspect: Tensor
               ) -> Tensor:
    """The straightening rotation (radians) of a crop whose structure
    orientation is ``theta``: the near-horizontal edge direction, corrected
    for the pixel aspect, clamped to +-``max_abs_deg``.  At ``theta`` near
    0 (vertical edges dominate) the result jumps from -max to +max with
    ``theta``'s sign."""
    tilt = theta - math.pi / 2
    tilt = torch.where(tilt <= -math.pi / 2, tilt + math.pi, tilt)
    tilt = torch.where(tilt > math.pi / 2, tilt - math.pi, tilt)
    tilt = torch.atan(torch.tan(tilt) / pixel_aspect)
    lim = math.radians(max_abs_deg)
    return tilt.clamp(-lim, lim)


def aspect_canvas(img: Tensor, canvas_hw) -> Tensor:
    """Images (N, sh, sw, C) resized, aspect kept, into centred black
    canvases (N, ch, cw, C)."""
    ch, cw = canvas_hw
    sh, sw = int(img.shape[1]), int(img.shape[2])
    scale = min(ch / sh, cw / sw)
    nh, nw = int(round(sh * scale)), int(round(sw * scale))
    canvas = img.new_zeros((img.shape[0], ch, cw, img.shape[-1]))
    t, l = (ch - nh) // 2, (cw - nw) // 2
    canvas[:, t:t + nh, l:l + nw] = resize(img, (nh, nw))
    return canvas
