"""Image resampling as interpolation-matrix products (counterpart of
``lpr_tpu/ops/resample.py``).

The JAX package phrases every crop of the pipeline as dense interpolation
matrices so that XLA runs them on the matrix unit; the port keeps the same
arithmetic, so both packages sample the same values, and leaves the
products to ``torch.einsum``.  Coordinates match
:func:`lpr_tpu_torch.ops.image.sample_bilinear`: pixel centres at i + 0.5,
border replicate by clipping.  Plate-level functions take frames
``(B, H, W, C)`` and boxes ``(B, P, 4)`` and return ``(B, P, ...)``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor

MAX_DESKEW_DEG = 15.0  # rotation budget the tile margins are sized for


def interp_weights(pos: Tensor, n_in: int) -> Tensor:
    """Bilinear row-interpolation matrix: pos (..., n_out) fractional
    source indices -> (..., n_out, n_in), 2 taps per row, positions clipped
    to the valid range (border replicate)."""
    pos = pos.clamp(0.0, n_in - 1.0)
    src = torch.arange(n_in, dtype=pos.dtype, device=pos.device)
    return (1.0 - (pos[..., :, None] - src).abs()).clamp(0.0, 1.0)


def _normalised(m: Tensor) -> Tensor:
    return m / m.sum(-1, keepdim=True).clamp(min=1e-8)


def resize_matmul(img: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Separable bilinear resize, (..., H, W, C) -> (..., oh, ow, C)."""
    h, w = int(img.shape[-3]), int(img.shape[-2])
    oh, ow = out_hw
    dev = img.device
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * (h / oh) - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * (w / ow) - 0.5
    ry = _normalised(interp_weights(ys, h)).to(img.dtype)
    rx = _normalised(interp_weights(xs, w)).to(img.dtype)
    t = torch.einsum("oh,...hwc->...owc", ry, img)
    return torch.einsum("pw,...owc->...opc", rx, t)


def extract_tile(frame: Tensor, center: Tensor, ext_wh: Tensor,
                 tile_hw: Tuple[int, int]) -> Tensor:
    """Axis-aligned crop+resize of frames (B, H, W, C) around centres
    (B, P, 2) with extents (B, P, 2) to tiles (B, P, Th, Tw, C)."""
    _, H, W, _ = frame.shape
    th, tw = tile_hw
    dev = frame.device
    cx, cy = center[..., 0:1], center[..., 1:2]
    ew, eh = ext_wh[..., 0:1], ext_wh[..., 1:2]
    ar_h = torch.arange(th, dtype=torch.float32, device=dev)
    ar_w = torch.arange(tw, dtype=torch.float32, device=dev)
    ys = cy - eh / 2 + (ar_h + 0.5) * (eh / th) - 0.5       # (B, P, th)
    xs = cx - ew / 2 + (ar_w + 0.5) * (ew / tw) - 0.5       # (B, P, tw)
    ry = _normalised(interp_weights(ys, H)).to(frame.dtype)  # (B, P, th, H)
    rx = _normalised(interp_weights(xs, W)).to(frame.dtype)  # (B, P, tw, W)
    t = torch.einsum("bpth,bhwc->bptwc", ry, frame)
    return torch.einsum("bpqw,bptwc->bptqc", rx, t)


def affine_resample(tile: Tensor, origin: Tensor, du_j: Tensor, dv_i: Tensor,
                    out_hw: Tuple[int, int]) -> Tensor:
    """Catmull-Smith two-pass affine warp of tiles (..., Th, Tw, C).

    Sampling coords (index space): (u, v)(i, j) = origin + j*du_j + i*dv_i,
    with origin/du_j/dv_i of shape (..., 2).  Pass 1 resamples each source
    row horizontally, pass 2 each output column vertically."""
    th, tw = int(tile.shape[-3]), int(tile.shape[-2])
    oh, ow = out_hw
    dev = tile.device
    a, c = du_j[..., 0, None, None], du_j[..., 1, None, None]
    b, d = dv_i[..., 0, None, None], dv_i[..., 1, None, None]
    tu, tv = origin[..., 0, None, None], origin[..., 1, None, None]
    d = torch.where(d.abs() < 1e-3,
                    torch.sign(d) * 1e-3 + (d == 0).to(d.dtype) * 1e-3, d)
    j_idx = torch.arange(ow, dtype=torch.float32, device=dev)
    vr = torch.arange(th, dtype=torch.float32, device=dev)
    # pass 1: per source row, horizontal positions (..., th, ow)
    u_p1 = (j_idx[None, :] * (a - b * c / d) + vr[:, None] * (b / d)
            + (tu - b * tv / d))
    m1 = interp_weights(u_p1, tw).to(tile.dtype)          # (..., th, ow, tw)
    f1 = torch.einsum("...rjw,...rwc->...rjc", m1, tile)  # (..., th, ow, C)
    # pass 2: per output column, vertical positions (..., ow, oh)
    i_idx = torch.arange(oh, dtype=torch.float32, device=dev)
    v_p2 = c * j_idx[:, None] + d * i_idx[None, :] + tv
    m2 = interp_weights(v_p2, th).to(tile.dtype)          # (..., ow, oh, th)
    return torch.einsum("...jir,...rjc->...ijc", m2, f1)  # (..., oh, ow, C)


def plate_tile(frame: Tensor, box: Tensor,
               tile_hw: Tuple[int, int] = (64, 256)):
    """Stage-1 extraction: an axis-aligned region around each box, sized to
    cover any rotation up to ``MAX_DESKEW_DEG``, resized to a fixed tile.

    frame (B, H, W, C), box (B, P, 4).  Returns (tile (B, P, Th, Tw, C),
    geom (cx, cy, su, sv)), each of geom (B, P); su/sv convert frame-px
    offsets from the box centre into tile-px offsets."""
    th, tw = tile_hw
    x1, y1, x2, y2 = box.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    slack = math.tan(math.radians(MAX_DESKEW_DEG))
    side = torch.maximum(bw, bh)
    ew = 1.05 * side + slack * bh
    eh = 1.05 * bh + slack * side
    tile = extract_tile(frame, torch.stack([cx, cy], -1),
                        torch.stack([ew, eh], -1), tile_hw)
    return tile, (cx, cy, tw / ew, th / eh)


def crop_rotated_fast(frame, box: Tensor, angle: Tensor,
                      out_hw: Tuple[int, int],
                      v_range: Tuple[float, float] = (-0.5, 0.5),
                      mask_outside: bool = False, square: bool = False,
                      tile_hw: Tuple[int, int] = (64, 256),
                      tile: Tensor = None, tile_geom=None) -> Tensor:
    """Matrix-product equivalent of ``ops.image.crop_rotated``.

    frame (B, H, W, C) (unused when ``tile``/``tile_geom`` from
    :func:`plate_tile` are given, so several crops share one extraction),
    box (B, P, 4), angle (B, P).  Returns (B, P, oh, ow, C)."""
    if tile is None:
        tile, tile_geom = plate_tile(frame, box, tile_hw)
    cx_t, cy_t, su, sv = tile_geom
    th, tw = int(tile.shape[-3]), int(tile.shape[-2])
    oh, ow = out_hw
    x1, y1, x2, y2 = box.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    v0, v1 = v_range
    if square:
        side = torch.maximum(bw, bh)
        w_span, h_span = side, side
    else:
        w_span, h_span = bw, bh
    ca, sa = torch.cos(angle), torch.sin(angle)

    def src_uv(i, j):
        du = ((j + 0.5) / ow - 0.5) * w_span
        dv = (v0 + (i + 0.5) / oh * (v1 - v0)) * h_span
        xf = cx + du * ca - dv * sa - 0.5
        yf = cy + du * sa + dv * ca - 0.5
        u = (xf - (cx_t - 0.5)) * su + (tw - 1) / 2
        v = (yf - (cy_t - 0.5)) * sv + (th - 1) / 2
        return torch.stack([u, v], -1)

    o = src_uv(0.0, 0.0)
    out = affine_resample(tile, o, src_uv(0.0, 1.0) - o,
                          src_uv(1.0, 0.0) - o, out_hw)
    if mask_outside:
        dev = box.device
        jj = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow - 0.5
        ii = v0 + (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5
                   ) / oh * (v1 - v0)
        du = jj[None, :] * w_span[..., None, None]
        dv = ii[:, None] * h_span[..., None, None]
        bw_, bh_ = bw[..., None, None], bh[..., None, None]
        inside = ((du.abs() <= bw_ / 2) & (dv >= bh_ * -0.5)
                  & (dv <= bh_ * 0.5))
        out = out * inside[..., None].to(out.dtype)
    return out
