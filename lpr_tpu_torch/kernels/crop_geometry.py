"""G1: the recognizer step's plate crops as one kernel
(``lpr_tpu_torch/csrc/crop_geometry.cu``), in place of the dense
interpolation-matrix products the JAX package phrases them as.

- :func:`plate_crops` — the wrapper.  A CUDA tensor goes to the kernel
  (built with nvcc, loaded with ctypes) or raises; only a CPU tensor takes
  the plain version.
- :func:`plate_crops_plain` — the plain version: the composition of
  :func:`lpr_tpu_torch.ops.resample.plate_tile`,
  :func:`~lpr_tpu_torch.ops.resample.crop_rotated_fast` and
  :func:`lpr_tpu_torch.ops.image.estimate_skew_angle` that the step ran
  before G1, the CPU step's route.
- :func:`compose_crops` — that composition around any crop sampler; the
  gather route (``PipelineConfig.fast_geometry=False``) passes
  :func:`lpr_tpu_torch.ops.image.crop_rotated`.
- :func:`crop_errors` — how far G1's outputs lie from the plain version
  in float32, beside :data:`TOL_ANGLE`, :data:`TOL_ABS` and
  :data:`TOL_REL`.
- :func:`crop_work` — the operations and bytes G1 needs, for its bound.

All take frames ``x`` (B, H, W, 3) in [0, 1] and boxes (B, P, 4) xyxy in
frame pixels and return (long_img (B, P, sh, sw, 3), ocr_orig (B, P, oh,
ow, 3), is_long (B, P) bool, angle (B, P) float32): the long crop, or for
a two-row plate its top and bottom halves side by side; the square crop
masked outside the box; the straightening angle the crops were taken at.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Tuple

import torch

from lpr_tpu_torch.kernels import refuse_export
from lpr_tpu_torch.ops import image as im
from lpr_tpu_torch.ops.resample import (MAX_DESKEW_DEG, crop_rotated_fast,
                                        plate_tile)

Tensor = torch.Tensor

# The plate tile G1 holds in shared memory (float32, 196,608 bytes).
TILE_HW = (64, 256)
# The skew estimate's crop and its largest correction.
SKEW_HW = (32, 96)
MAX_SKEW_DEG = 15.0

# How close G1 comes to the plain version in float32.  The angle: within
# TOL_ANGLE rad wherever the skew crop's structure orientation lies
# ILL_BAND rad or more from 0; nearer 0 the straightening angle jumps
# between its two clamps, and the means' summation order decides which
# (ops/image.py estimate_skew_angle).  The crops, taken by the plain version
# at G1's angle: the same taps summed in another order move a value by
# float32 rounding of the positions (a few 1e-5 px) times the image's
# slope, within TOL_ABS; a bf16 output adds its rounding, half an ulp,
# 2^-8 of the value.  (At its own angle the plain version may differ more:
# 1e-5 rad of rounding in the angle moves a pixel 100 px from the centre
# by 1e-3 px.)
TOL_ANGLE = 1e-4
ILL_BAND = 0.01
TOL_ABS = 1e-4
TOL_REL = {torch.bfloat16: 2.0 ** -8, torch.float32: 0.0}
# The launcher of each frame dtype.
_LAUNCHERS = {torch.bfloat16: "lpr_crop_geometry_bf16",
              torch.float32: "lpr_crop_geometry_f32"}

LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p] * 5)


@functools.cache
def _lib():
    from lpr_tpu_torch.kernels._build import library

    lib = library("crop_geometry")
    for name in _LAUNCHERS.values():
        fn = getattr(lib, name)
        fn.argtypes = LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def compose_crops(crop: Callable, boxes: Tensor,
                  sr_hw: Tuple[int, int], ocr_hw: Tuple[int, int],
                  long_aspect: float, deskew: bool, angle: Tensor = None):
    """The plate crops from a sampler ``crop(angle, out_hw, **kw)`` (the
    keywords of :func:`lpr_tpu_torch.ops.image.crop_rotated`): the skew
    estimate on the 32x96 crop at angle 0, then the long crop, its two
    halves and the masked square crop at that angle, or at ``angle``
    (B, P) where one is given."""
    B, P = boxes.shape[:2]
    # width clamped like the height: the JAX step divides by the raw
    # width, which gives NaN crops in empty (zero-box) plate slots
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1.0)
    sh, sw = sr_hw
    zero = torch.zeros((B, P), dtype=torch.float32, device=boxes.device)
    gray = im.rgb_to_gray(crop(zero, SKEW_HW).float())
    aspect = (w / 96.0) / (h / 32.0)
    estimate = im.estimate_skew_angle(gray, max_abs_deg=MAX_SKEW_DEG,
                                      pixel_aspect=aspect)
    if not deskew:
        estimate = estimate * 0.0
    if angle is None:
        angle = estimate
    is_long = (w / h) > long_aspect
    full = crop(angle, (sh, sw))
    top = crop(angle, (sh, sw // 2), v_range=(-0.5, 0.0))
    bot = crop(angle, (sh, sw // 2), v_range=(0.0, 0.5))
    two_row = torch.cat([top, bot], dim=-2)
    long_img = torch.where(is_long[..., None, None, None], full, two_row)
    ocr_orig = crop(angle, ocr_hw, square=True, mask_outside=True)
    return long_img, ocr_orig, is_long, angle


def plate_crops_plain(x: Tensor, boxes: Tensor,
                      sr_hw: Tuple[int, int] = (32, 192),
                      ocr_hw: Tuple[int, int] = (128, 128),
                      tile_hw: Tuple[int, int] = TILE_HW,
                      long_aspect: float = 1.5, deskew: bool = True,
                      angle: Tensor = None):
    """G1's function in plain PyTorch: one tile extraction a plate and the
    crops through interpolation-matrix products, in ``x``'s dtype (with
    ``angle``, the crops at that angle: :func:`compose_crops`)."""
    tile, geom = plate_tile(x, boxes, tile_hw)

    def crop(angle, out_hw, **kw):
        return crop_rotated_fast(x, boxes, angle, out_hw, tile=tile,
                                 tile_geom=geom, **kw)

    return compose_crops(crop, boxes, sr_hw, ocr_hw, long_aspect, deskew,
                         angle)


def plate_crops(x: Tensor, boxes: Tensor,
                sr_hw: Tuple[int, int] = (32, 192),
                ocr_hw: Tuple[int, int] = (128, 128),
                tile_hw: Tuple[int, int] = TILE_HW,
                long_aspect: float = 1.5, deskew: bool = True):
    """The plate crops of frames x (B, H, W, 3) at boxes (B, P, 4).

    A CUDA tensor launches G1 on the current stream (bfloat16 or float32
    frames, contiguous; float32 boxes on the same card, contiguous; the
    tile ``TILE_HW``; an even crop width; anything else raises) and adds
    one to ``plate_crops.launches``: sampling and the angle in float32, the
    crops rounded once to the frames' dtype.  A CPU tensor takes
    :func:`plate_crops_plain`."""
    refuse_export("plate_crops")
    if x.device.type == "cpu":
        return plate_crops_plain(x, boxes, sr_hw, ocr_hw, tile_hw,
                                 long_aspect, deskew)
    if x.device.type != "cuda":
        raise ValueError(f"plate_crops runs on cuda or cpu, not {x.device}")
    if x.dtype not in _LAUNCHERS:
        raise ValueError(f"plate_crops takes bfloat16 or float32 frames, "
                         f"got {x.dtype}")
    if x.dim() != 4 or x.shape[3] != 3 or 0 in x.shape:
        raise ValueError(f"expected frames (B, H, W, 3), got "
                         f"{tuple(x.shape)}")
    B, H, W, _ = x.shape
    if (boxes.dim() != 3 or boxes.shape[0] != B or boxes.shape[2] != 4
            or boxes.shape[1] == 0):
        raise ValueError(f"expected boxes ({B}, P, 4), got "
                         f"{tuple(boxes.shape)}")
    if boxes.dtype != torch.float32 or boxes.device != x.device:
        raise ValueError(f"boxes must be float32 on {x.device}, got "
                         f"{boxes.dtype} on {boxes.device}")
    if not (x.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("plate_crops takes contiguous frames and boxes")
    if tuple(tile_hw) != TILE_HW:
        raise ValueError(f"G1 holds a {TILE_HW} tile, not {tuple(tile_hw)}")
    (sh, sw), (oh, ow) = sr_hw, ocr_hw
    if min(sh, sw, oh, ow) <= 0 or sw % 2:
        raise ValueError(f"G1 needs positive crop sizes and an even crop "
                         f"width, got {sr_hw} and {ocr_hw}")
    P = boxes.shape[1]
    long_img = torch.empty((B, P, sh, sw, 3), dtype=x.dtype, device=x.device)
    ocr = torch.empty((B, P, oh, ow, 3), dtype=x.dtype, device=x.device)
    is_long = torch.empty((B, P), dtype=torch.bool, device=x.device)
    angle = torch.empty((B, P), dtype=torch.float32, device=x.device)
    lib = _lib()
    fn = getattr(lib, _LAUNCHERS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), boxes.data_ptr(), B, P, H, W, sh, sw, oh, ow,
                 float(long_aspect), int(bool(deskew)), long_img.data_ptr(),
                 ocr.data_ptr(), is_long.data_ptr(), angle.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"crop_geometry kernel launch failed: cudaError "
                           f"{err}")
    plate_crops.launches += 1
    return long_img, ocr, is_long, angle


plate_crops.launches = 0


def orientation(x: Tensor, boxes: Tensor) -> Tensor:
    """The structure orientation (B, P) of the plain version's skew crop,
    the angle ``estimate_skew_angle`` folds: near 0 the straightening angle
    is ill-conditioned."""
    tile, geom = plate_tile(x, boxes, TILE_HW)
    zero = torch.zeros(boxes.shape[:2], dtype=torch.float32, device=x.device)
    gray = im.rgb_to_gray(crop_rotated_fast(
        x, boxes, zero, SKEW_HW, tile=tile, tile_geom=geom).float())
    gx, gy = im.sobel_gradients(gray)
    return 0.5 * torch.atan2((2.0 * gx * gy).mean(dim=(-2, -1)),
                             (gx * gx - gy * gy).mean(dim=(-2, -1)))


def crop_errors(got, x: Tensor, boxes: Tensor, **kw):
    """How far G1's outputs ``got`` (:func:`plate_crops`) on frames x lie
    from the plain version in float32 on the same frames: (is_long equal,
    the largest angle error where the orientation lies outside
    ``ILL_BAND``, that band's slots, the largest crop error over
    TOL_ABS + TOL_REL x |plain| against the crops taken at G1's angle).
    The check holds where the flags are equal and both ratios are below
    1.  ``kw``: :func:`plate_crops_plain`'s shapes and settings."""
    x = x.float()
    want = plate_crops_plain(x, boxes, **kw)
    band = orientation(x, boxes).abs() < ILL_BAND
    d_angle = (got[3] - want[3]).abs()[~band]
    at = plate_crops_plain(x, boxes, angle=got[3], **kw)
    rel = TOL_REL[got[0].dtype]
    ratio = max(float(((g.float() - w).abs() / (TOL_ABS + rel * w.abs())
                       ).max()) for g, w in zip(got[:2], at[:2]))
    return (bool(torch.equal(got[2], want[2])),
            float(d_angle.max()) / TOL_ANGLE if d_angle.numel() else 0.0,
            int(band.sum()), ratio)


def crop_work(boxes: Tensor, frame_hw: Tuple[int, int],
              sr_hw: Tuple[int, int] = (32, 192),
              ocr_hw: Tuple[int, int] = (128, 128),
              elt_bytes: int = 2) -> Tuple[int, int]:
    """(floating-point operations, bytes) G1 needs for boxes (B, P, 4) on
    frames of ``frame_hw``: each frame pixel that a plate tile's taps
    touch read once (the union over a frame's plates), the boxes read and
    the crops, flags and angles written once; three float operations a
    two-tap lerp, three lerps a value of the tile and of each crop
    (the skew crop included)."""
    H, W = frame_hw
    th, tw = TILE_HW
    B, P = boxes.shape[:2]
    b = boxes.detach().to(torch.float64).cpu()
    x1, y1, x2, y2 = b.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    slack = math.tan(math.radians(MAX_DESKEW_DEG))
    side = torch.maximum(bw, bh)
    ew, eh = 1.05 * side + slack * bh, 1.05 * bh + slack * side

    def touched(c, e, n_tap, n):
        pos = (c[..., None] - e[..., None] / 2
               + (torch.arange(n_tap, dtype=torch.float64) + 0.5)
               * (e[..., None] / n_tap) - 0.5).clamp(0, n - 1)
        i0 = pos.floor().long()
        return torch.cat([i0, (i0 + 1).clamp(max=n - 1)], -1)

    rows, cols = touched(cy, eh, th, H), touched(cx, ew, tw, W)
    read = 0
    for f in range(B):
        mask = torch.zeros((H, W), dtype=torch.bool)
        for p in range(P):
            mask[rows[f, p].unique()[:, None], cols[f, p].unique()] = True
        read += int(mask.sum()) * 3 * elt_bytes
    (sh, sw), (oh, ow) = sr_hw, ocr_hw
    per_slot_values = 3 * (th * tw + SKEW_HW[0] * SKEW_HW[1] + sh * sw
                           + oh * ow)
    written = B * P * (3 * (sh * sw + oh * ow) * elt_bytes + 1 + 4)
    return 9 * B * P * per_slot_values, read + 16 * B * P + written
