"""Core NHWC neural-net ops (counterpart of ``lpr_tpu/ops/nn.py``).

Activations are NHWC at every public function, as in the JAX package.
The int8 path (:func:`quantize_conv_weight`, :func:`conv2d_int8`) runs on
a card through the hand-written kernels of
``lpr_tpu_torch/kernels/conv_int8.py`` and on the CPU through their plain
versions.  A
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


def quantize_conv_weight(w) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 quantization of an HWIO conv
    weight (``lpr_tpu.ops.nn.quantize_conv_weight``): (int8 weight,
    float32 per-Cout scale).  numpy in float32, the JAX function's
    operations in its order (amax / 127, floor 1e-12, round half to even,
    clip to +-127), so the bytes equal JAX's."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=(0, 1, 2))
    scale = np.maximum(amax / np.float32(127.0), np.float32(1e-12))
    wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return wq, scale.astype(np.float32)


def conv2d_int8(x: Tensor, w_q: Tensor, w_scale: Tensor,
                b: Optional[Tensor] = None, *,
                stride: Union[int, Tuple[int, int]] = 1,
                padding: PadLike = "same", groups: int = 1,
                packed: Optional[Tensor] = None,
                xq: Optional[Tuple[Tensor, Tensor]] = None,
                act: str = "none", residual: Optional[Tensor] = None,
                amax: Optional[Tensor] = None) -> Tensor:
    """Dynamically quantized int8 convolution (``lpr_tpu.ops.nn
    .conv2d_int8``): the activations quantized per tensor on the fly
    (max|x| / 127 over the whole batch), int8 x int8 -> int32, then
    ``float(acc) * (sx * w_scale) + b`` in float32, rounded to ``x``'s
    dtype.  ``w_q`` is an HWIO int8 tensor, ``w_scale`` and ``b`` float32
    (Cout,).

    The port's model passes more (the JAX-facing call passes none of it):
    ``xq``, the codes and scale of ``x`` already quantized (a tensor read
    by two convs is quantized once); ``act`` (``"none"``, ``"silu"``,
    ``"leaky"``) and ``residual`` (added after it), the layer's activation
    and its Bottleneck's shortcut; ``amax``, a float32 slot that takes the
    output's max|y| for the next layer's quantize.

    On a CUDA tensor the quantize is kernel I1 and the convolution, with
    all of that in its epilogue, kernel I2 (``kernels/conv_int8.py``;
    ``packed``: the weight in I2's layout,
    :func:`~lpr_tpu_torch.kernels.conv_int8.int8_pack`, packed here when
    None); on a CPU tensor their plain versions."""
    from lpr_tpu_torch.kernels import conv_int8 as ki

    kh, kw = int(w_q.shape[0]), int(w_q.shape[1])
    pad = _resolve_padding(padding, kh, kw)
    st = (stride, stride) if isinstance(stride, int) else tuple(stride)
    codes, sx = ki.quantize_act(x) if xq is None else xq
    if packed is None and x.device.type == "cuda":
        packed = ki.int8_pack(w_q)
    return ki.conv_int8(codes, sx, w_q, w_scale, b, stride=st, padding=pad,
                        groups=groups, out_dtype=x.dtype, packed=packed,
                        act=act, residual=residual, amax=amax)


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


def relu(x: Tensor) -> Tensor:
    return torch.clamp_min(x, 0)


def leaky_relu(x: Tensor, slope: float = 0.2) -> Tensor:
    """``where(x >= 0, x, slope * x)``, as the JAX package's."""
    return torch.where(x >= 0, x, slope * x)


def act(x: Tensor, name: str) -> Tensor:
    """A YOLO conv's activation by name: ``"silu"`` (:func:`silu`),
    ``"leaky"`` (:func:`leaky_relu` at the YOLO builder's slope 0.1) or
    ``"none"``."""
    if name == "silu":
        return silu(x)
    if name == "leaky":
        return leaky_relu(x, 0.1)
    if name != "none":
        raise ValueError(f"act must be silu, leaky or none, got {name!r}")
    return x


def max_pool2d(x: Tensor, k: int, stride: int = 1,
               padding: Optional[int] = None) -> Tensor:
    """Max pool, NHWC, torch semantics (symmetric pad, -inf fill)."""
    if padding is None:
        padding = k // 2
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x: Tensor, k: int, stride: int = 1, padding: int = 0
               ) -> Tensor:
    """Average pool, NHWC: the window sum over zero padding divided by
    k * k (padding counted, as the JAX ``reduce_window`` sum)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), k, stride, padding,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: Tensor) -> Tensor:
    """(N, H, W, C) -> (N, C): AdaptiveAvgPool2d(1) + Flatten."""
    return x.mean(dim=(1, 2))


def instance_norm(x: Tensor, eps: float = 1e-5) -> Tensor:
    """InstanceNorm2d with torch's defaults (affine=False) over H, W of an
    NHWC batch: ``(x - mean) * rsqrt(var + eps)``, biased variance, as the
    JAX package's."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def reflect_pad2d(x: Tensor, pad: int) -> Tensor:
    """Reflection padding of H and W (numpy's ``mode="reflect"``)."""
    return F.pad(x.permute(0, 3, 1, 2), (pad,) * 4,
                 mode="reflect").permute(0, 2, 3, 1)


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


# How a buffer's tensor is made from the flat state's (HWIO) tensor: the
# one place where the trainers' HWIO leaves meet the modules' layouts.
_TO_BUFFER = {
    None: lambda t: t,
    "hwio": lambda t: t.permute(3, 2, 0, 1),     # HWIO -> OIHW, a view
    "scalar": lambda t: t.reshape(()),
}


class Conv2d(torch.nn.Module):
    """A conv layer held as OIHW weight + bias buffers, applied NHWC.

    Built from HWIO numpy arrays with :meth:`from_hwio`.  The weights are
    buffers, so inference builds no autograd graph and the frozen graphs,
    the kernels' packs and the exporters read them as they are.  Training
    does not make them parameters: a layer built from a flat state names
    its keys (``key``, the state prefix, kept in :attr:`state_keys`), and
    the trainers run the module through ``torch.func.functional_call``
    with :func:`state_to_buffers` of their HWIO leaf tensors."""

    def __init__(self, w_oihw: np.ndarray, b: Optional[np.ndarray], *,
                 stride=1, padding: PadLike = "same", groups: int = 1,
                 key: Optional[str] = None):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(
            np.ascontiguousarray(w_oihw, np.float32)))
        self.register_buffer(
            "b", None if b is None else torch.from_numpy(
                np.ascontiguousarray(b, np.float32)))
        self.stride, self.padding, self.groups = stride, padding, groups
        self.state_keys = {} if key is None else {"w": (f"{key}/w", "hwio")}
        if key is not None and b is not None:
            self.state_keys["b"] = (f"{key}/b", None)

    @classmethod
    def from_hwio(cls, w, b=None, **kw) -> "Conv2d":
        return cls(hwio_to_oihw(w), b, **kw)

    def forward(self, x: Tensor) -> Tensor:
        return conv2d(x, self.w, self.b, stride=self.stride,
                      padding=self.padding, groups=self.groups)


def state_to_buffers(module: torch.nn.Module, tensors) -> dict:
    """{buffer name: tensor} for ``torch.func.functional_call(module,
    ...)``: each buffer that a submodule's ``state_keys`` ({local buffer:
    (state key, layout)}) ties to a key of the flat state ``tensors``,
    made from that tensor in the buffer's layout (an HWIO conv weight as
    its OIHW view), so gradients reach the HWIO tensors."""
    out = {}
    for name, mod in module.named_modules():
        for local, (key, layout) in getattr(mod, "state_keys", {}).items():
            if key in tensors:
                full = f"{name}.{local}" if name else local
                out[full] = _TO_BUFFER[layout](tensors[key])
    return out


@torch.no_grad()
def load_state_into(module: torch.nn.Module, tensors) -> None:
    """Copy the flat state ``tensors`` into ``module``'s buffers in place
    (:func:`state_to_buffers`' mapping)."""
    for name, t in state_to_buffers(module, tensors).items():
        module.get_buffer(name).copy_(t)
