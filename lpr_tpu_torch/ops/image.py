"""Device-side image ops (counterpart of ``lpr_tpu/ops/image.py``): resize
(bilinear and bicubic, ``jax.image.resize``'s semantics), letterbox,
oriented crop sampling, skew estimation and the HSV value scale of the LR
degradation.

The JAX functions work on one image and are ``vmap``-ed by the pipeline;
here the batch dimensions are written out.  Plate-level functions take
frames ``(B, H, W, C)``, boxes ``(B, P, 4)`` and angles ``(B, P)``, and
return ``(B, P, ...)``.  Their small constant tables (the gray weights, the
resize matrices, the letterbox pad) are built once per shape, dtype and
device, as ordinary tensors even under inference mode, so a step uploads
none after its first call (the precondition for capturing it as a CUDA
graph).

:func:`letterbox_host` is the host half of the packed-input path: uint8
frames letterboxed into the detector's input by the port's C letterbox, as
the JAX package's ``pack_front_frames_host`` and the native
``letterbox_into`` do it; :func:`letterbox_host_plain` is its numpy
reference.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def uint8_to_float(x: Tensor) -> Tensor:
    """uint8 [0, 255] -> float32 [0, 1]."""
    return x.to(torch.float32) / 255.0


def float_to_uint8(x: Tensor) -> Tensor:
    """float [0, 1] -> uint8: clipped, scaled by 255 and rounded half to
    even (``torch.round``, as ``jnp.round`` rounds in the JAX package)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _gray_weights(dtype, device) -> Tensor:
    return torch.tensor([0.299, 0.587, 0.114], dtype=dtype, device=device)


def rgb_to_gray(x: Tensor) -> Tensor:
    """ITU-R BT.601 luma (OpenCV convention), (..., 3) -> (...)."""
    return x @ _gray_weights(x.dtype, x.device)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - x)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5
    (``jax._src.image.scale._fill_keys_cubic_kernel``), in float32."""
    one, two = np.float32(1.0), np.float32(2.0)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + one
    out = np.where(x >= one, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + two, out)
    return np.where(x >= two, np.float32(0.0), out).astype(np.float32)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, method: str = "linear"
                   ) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(..., method)`` along one
    axis, ``method`` ``"linear"`` (a triangle) or ``"cubic"`` (Keys,
    a = -0.5): the kernel widened by the down-scale factor (antialiasing),
    each row normalised to sum 1 (``jax._src.image.scale``
    ``compute_weight_mat`` with translation 0)."""
    inv_scale = np.float32(1.0 / (n_out / n_in))   # in float64, as JAX
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return np.ascontiguousarray(w.T.astype(np.float32))


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _resize_matrix(n_in: int, n_out: int, dtype, device,
                   method: str = "linear") -> Tensor:
    """:func:`resize_weights` on ``device`` in ``dtype``, built once."""
    return torch.from_numpy(resize_weights(n_in, n_out, method)).to(
        device, dtype)


def _resize(x: Tensor, out_hw: Tuple[int, int], method: str) -> Tensor:
    h, w = int(x.shape[-3]), int(x.shape[-2])
    oh, ow = out_hw
    if oh != h:
        ry = _resize_matrix(h, oh, x.dtype, x.device, method)
        x = torch.einsum("oh,...hwc->...owc", ry, x)
    if ow != w:
        rx = _resize_matrix(w, ow, x.dtype, x.device, method)
        x = torch.einsum("pw,...owc->...opc", rx, x)
    return x


def resize_bilinear(x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Bilinear resize of (..., H, W, C) with ``jax.image.resize``'s
    ``"linear"`` semantics (antialiased when shrinking)."""
    return _resize(x, out_hw, "linear")


def resize_bicubic(x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Bicubic resize of (..., H, W, C) with ``jax.image.resize``'s
    ``"cubic"`` semantics: Keys' kernel, widened by the down-scale factor
    when shrinking (the degradation's x0.35 step is such a shrink)."""
    return _resize(x, out_hw, "cubic")


def hsv_value_scale(rgb: Tensor, scale: Tensor) -> Tensor:
    """Scale the HSV V channel of RGB [0, 1] images (..., H, W, 3) by
    ``scale`` (..., H, W) without leaving RGB: V = max(R, G, B), every
    channel scaled by clip(V * scale, 0, 1) / V (0 where V is 0)."""
    v = rgb.amax(dim=-1, keepdim=True)
    new_v = torch.clamp(v * scale[..., None], 0.0, 1.0)
    ratio = torch.where(v > 0, new_v / torch.clamp_min(v, 1e-6),
                        torch.zeros((), dtype=v.dtype, device=v.device))
    return rgb * ratio


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
    return out, float(gain), letterbox_pad(pad_left, pad_top, x.device)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def letterbox_pad(pad_left: int, pad_top: int, device) -> Tensor:
    """The letterbox pad (2,) float32 = (pad_x, pad_y) on ``device``, built
    once."""
    return torch.tensor([pad_left, pad_top], dtype=torch.float32,
                        device=device)


def _resize_u8(frames: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Bilinear resize of uint8 frames (B, h, w, 3) -> (B, nh, nw, 3): the
    native ``letterbox_into``'s taps (``native/lpr_native.cc``): half-pixel
    centres clamped at 0, the second tap clamped to the last pixel, the
    weights in float32, horizontal then vertical, rounded with +0.5."""
    _, h, w, _ = frames.shape

    def taps(n_in, n_out):
        f = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.where(f < 0, 0, f.astype(np.int64))
        i1 = np.minimum(i0 + 1, n_in - 1)
        wt = np.where(f < i0, 0.0, f - i0).astype(np.float32)
        return i0, i1, wt

    y0, y1, wy = taps(h, nh)
    x0, x1, wx = taps(w, nw)
    wx = wx[None, None, :, None]
    one = np.float32(1.0)

    def rows(ys):
        r = frames[:, ys].astype(np.float32)
        return r[:, :, x0] * (one - wx) + r[:, :, x1] * wx

    wy = wy[None, :, None, None]
    v = rows(y0) * (one - wy) + rows(y1) * wy + np.float32(0.5)
    return v.astype(np.uint8)


def _check_frames_u8(frames) -> np.ndarray:
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 3:
        raise ValueError(f"expected uint8 frames (B, H, W, 3), got "
                         f"{frames.dtype} {frames.shape}")
    return frames


def letterbox_host(frames_u8, det_hw: Tuple[int, int], out=None
                   ) -> np.ndarray:
    """Letterbox uint8 frames (B, H, W, 3), or a sequence of B (H, W, 3)
    frames, on the host into the detector input (B, oh, ow, 3) uint8, zero
    pad, with :func:`letterbox_geom`'s geometry, through the threaded C
    batch letterbox
    (``csrc/host_letterbox.cc``, :func:`lpr_tpu_torch.native.
    letterbox_batch_into`): the letterbox half of the JAX package's
    ``pack_front_frames_host`` and of the native ``letterbox_into``.  A
    pad-only letterbox (720p into 736x1280) is a row copy; a resize takes
    the native bilinear taps.  The bytes equal :func:`letterbox_host_plain`'s.
    ``out`` (a uint8 host array or tensor of the result's shape, such as
    the pinned staging buffer) is written in place of a new array; the
    result is K1's own input layout, NHWC, not the TPU kernel's
    quarter-grid planes."""
    from lpr_tpu_torch import native

    frames = (frames_u8 if isinstance(frames_u8, (list, tuple))
              else np.asarray(frames_u8))
    if not len(frames):
        raise ValueError("no frames to letterbox")
    B = len(frames)
    h, w = np.shape(frames[0])[:2]      # the C entry checks the rest
    _, (nh, nw), (left, top) = letterbox_geom(h, w, det_hw)
    if out is None:
        out = np.empty((B, *det_hw, 3), np.uint8)
    native.letterbox_batch_into(frames, out, (nh, nw, top, left))
    return out


def letterbox_host_plain(frames_u8: np.ndarray, det_hw: Tuple[int, int]
                         ) -> np.ndarray:
    """:func:`letterbox_host` in numpy: the reference its C is held to byte
    for byte.  A resize takes the native bilinear taps
    (:func:`_resize_u8`)."""
    frames = _check_frames_u8(frames_u8)
    B, h, w, _ = frames.shape
    oh, ow = det_hw
    _, (nh, nw), (left, top) = letterbox_geom(h, w, det_hw)
    out = np.empty((B, oh, ow, 3), np.uint8)
    # zero only the pad: each byte is written once
    out[:, :top] = 0
    out[:, top + nh:] = 0
    out[:, top:top + nh, :left] = 0
    out[:, top:top + nh, left + nw:] = 0
    out[:, top:top + nh, left:left + nw] = (
        frames if (nh, nw) == (h, w) else _resize_u8(frames, nh, nw))
    return out


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
