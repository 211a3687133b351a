"""Core NHWC neural-net ops (counterpart of ``lpr_tpu/ops/nn.py``).

Activations are NHWC at every public function, as in the JAX package.  A
contiguous NHWC tensor permuted to NCHW is PyTorch's ``channels_last``
layout, so each convolution here hands cuDNN a channels-last view and
permutes its output back — no copies.  Conv weights are OIHW (PyTorch's own
layout); :func:`hwio_to_oihw` converts the checkpoints' HWIO arrays once,
at load time.  Padding follows PyTorch's explicit symmetric semantics, like
the JAX package's ``_resolve_padding``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
PadLike = Union[str, int, Tuple[int, int]]

BN_EPS = 1e-3  # YOLO BatchNorm2d eps (lpr_tpu/models/yolo.py _BN_EPS)


def hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    """(kh, kw, cin, cout) -> (cout, cin, kh, kw), contiguous."""
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def _resolve_padding(padding: PadLike, kh: int, kw: int) -> Tuple[int, int]:
    """Symmetric (pad_h, pad_w): ``"same"`` is k // 2 per dimension."""
    if padding == "same":
        return (kh // 2, kw // 2)
    if isinstance(padding, int):
        return (padding, padding)
    ph, pw = padding
    return (int(ph), int(pw))


def conv2d(x: Tensor, w: Tensor, b: Optional[Tensor] = None, *,
           stride: Union[int, Tuple[int, int]] = 1,
           padding: PadLike = "same", groups: int = 1,
           dilation: Union[int, Tuple[int, int]] = 1) -> Tensor:
    """2-D convolution, NHWC x OIHW -> NHWC (torch padding semantics).

    The weight and bias are cast to ``x``'s dtype, as the JAX ``conv2d``
    casts its weight."""
    pad = _resolve_padding(padding, int(w.shape[2]), int(w.shape[3]))
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype),
                 None if b is None else b.to(x.dtype), stride=stride,
                 padding=pad, dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d(x: Tensor, w: Tensor, b: Optional[Tensor] = None, *,
                     stride=1, padding: PadLike = "same",
                     dilation=1) -> Tensor:
    """Depthwise conv; ``w`` is (C, 1, kh, kw) (torch groups=C layout)."""
    return conv2d(x, w, b, stride=stride, padding=padding,
                  groups=int(x.shape[-1]), dilation=dilation)


def linear(x: Tensor, w: Tensor, b: Optional[Tensor] = None) -> Tensor:
    """Dense layer; ``w`` is (in, out), as in the JAX package."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def fuse_conv_bn(w, b, gamma, beta, mean, var, eps: float = BN_EPS):
    """Fold inference batch norm into HWIO conv weights (numpy), exactly as
    ``lpr_tpu.ops.nn.fuse_conv_bn``."""
    w = np.asarray(w, np.float32)
    scale = np.asarray(gamma, np.float32) / np.sqrt(
        np.asarray(var, np.float32) + eps)
    w_f = w * scale.reshape(1, 1, 1, -1)
    b0 = (np.zeros(w.shape[-1], np.float32) if b is None
          else np.asarray(b, np.float32))
    b_f = (b0 - np.asarray(mean, np.float32)) * scale + np.asarray(
        beta, np.float32)
    return w_f, b_f


def s2d_stem_weight(w6: np.ndarray) -> np.ndarray:
    """HWIO (6, 6, c1, c2) stem weight -> (3, 3, 4*c1, c2) for
    space-to-depth(2) + 3x3/p1: ``W'[a, b, c*4 + i*2 + j] = W[2a+i, 2b+j, c]``
    (``lpr_tpu/models/yolo.py`` ``Conv._is_s2d_stem``).  The detector's
    loader and the front kernel's packer both take their stem weight from
    here."""
    w6 = np.asarray(w6, np.float32)
    c1, c2 = w6.shape[2], w6.shape[3]
    w = w6.reshape(3, 2, 3, 2, c1, c2).transpose(0, 2, 4, 1, 3, 5)
    return np.ascontiguousarray(w.reshape(3, 3, c1 * 4, c2))


def silu(x: Tensor) -> Tensor:
    """SiLU with the JAX package's subnormal flush: ``|y| < 1e-30 -> 0``."""
    y = x * torch.sigmoid(x)
    return torch.where(y.abs() < 1e-30, torch.zeros((), dtype=y.dtype,
                                                     device=y.device), y)


def max_pool2d(x: Tensor, k: int, stride: int = 1,
               padding: Optional[int] = None) -> Tensor:
    """Max pool, NHWC, torch semantics (symmetric pad, -inf fill)."""
    if padding is None:
        padding = k // 2
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, padding)
    return y.permute(0, 2, 3, 1)


def pixel_unshuffle(x: Tensor, r: int) -> Tensor:
    """Space-to-depth, NHWC, torch channel order ``c*r*r + i*r + j``."""
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def pixel_shuffle(x: Tensor, r: int) -> Tensor:
    """Depth-to-space, NHWC, inverse of :func:`pixel_unshuffle`."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def space_to_depth_focus(x: Tensor) -> Tensor:
    """YOLO ``Focus`` slicing: concat of x[::2,::2], x[1::2,::2],
    x[::2,1::2], x[1::2,1::2] on channels (NHWC)."""
    return torch.cat([x[:, ::2, ::2], x[:, 1::2, ::2],
                      x[:, ::2, 1::2], x[:, 1::2, 1::2]], dim=-1)


def upsample_nearest(x: Tensor, scale: int = 2) -> Tensor:
    """Nearest-neighbour upsample by an integer factor, NHWC."""
    n, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c)
    return y.reshape(n, h * scale, w * scale, c)


class Conv2d(torch.nn.Module):
    """A conv layer held as OIHW weight + bias buffers, applied NHWC.

    Built from HWIO numpy arrays with :meth:`from_hwio`; the port runs
    inference only, so parameters are buffers and carry no gradients."""

    def __init__(self, w_oihw: np.ndarray, b: Optional[np.ndarray], *,
                 stride=1, padding: PadLike = "same", groups: int = 1):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(
            np.ascontiguousarray(w_oihw, np.float32)))
        self.register_buffer(
            "b", None if b is None else torch.from_numpy(
                np.ascontiguousarray(b, np.float32)))
        self.stride, self.padding, self.groups = stride, padding, groups

    @classmethod
    def from_hwio(cls, w, b=None, **kw) -> "Conv2d":
        return cls(hwio_to_oihw(w), b, **kw)

    def forward(self, x: Tensor) -> Tensor:
        return conv2d(x, self.w, self.b, stride=self.stride,
                      padding=self.padding, groups=self.groups)
