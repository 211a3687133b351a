"""I1 and I2: the int8 convolution of the quantized plate detector, the
port of ``lpr_tpu/ops/nn.py:129`` ``conv2d_int8`` (``lax.conv`` on int8
operands, not a Pallas kernel; PyTorch has no int8 convolution on CUDA).

- I1, the per-tensor quantize, in two kernels.  :func:`act_amax` (the max
  pass) takes the whole tensor's max|x| (the batch included) into a
  float32 slot by ``atomicMax`` on the float's bits; it runs only where
  the max is not already known.  :func:`quantize_act` (the quantize) reads
  1-4 such slots, ``sx = max(max(slots) / 127, 1e-12)``, and writes ``xq =
  clamp(rint(x / sx), -127, 127)`` as int8 NHWC, channels padded with
  zeros to a multiple of 32 (:func:`padded_channels`), and sx, which stays
  on the device.  Counted in ``act_amax.launches`` and
  ``quantize_act.launches``.
- I2, :func:`conv_int8` — the implicit-GEMM convolution on ``wgmma`` (m64
  x N x k32, s8 -> s32), both operands brought by TMA: the weight as
  :func:`int8_pack`'s K-major matrix (packed once at load, its descriptor,
  :func:`weight_map`, encoded once per weight), the input as strided boxes
  of a spatial output tile (:func:`tile_shape`) at each tap, zeros off the
  image; then the JAX function's float32 epilogue ``float(acc) * (sx *
  w_s) + b`` rounded to the output dtype, and fused behind it the layer's
  activation (none, SiLU, leaky), the Bottleneck's residual and the
  per-tensor max of what it stores, into a slot that the next quantize
  reads (or, with ``raw``, the int32 sums).  It takes ``groups == 1``,
  kernels 1, 3 and 5, stride 1 or 2, any Cin; a CUDA launch of anything
  else raises.  Counted in ``conv_int8.launches``.

A CUDA tensor launches the kernels in ``lpr_tpu_torch/csrc/conv_int8.cu``
on the current stream, or raises; a CPU tensor takes the plain versions
(:func:`act_amax_plain`, :func:`quantize_act_plain`,
:func:`conv_int8_plain`), which compute the same chain: the exact int32
sums, the epilogue, ``ops.nn.silu`` or ``leaky_relu``, ``+ residual``,
then the max of the result.

Bounds on an H100 SXM: I1 by bytes (3.35 TB/s; its operations at the 67
TFLOP/s float32 rate), I2 by int8 operations (1,979 TOPS dense) or bytes;
:func:`amax_work`, :func:`quantize_work` and :func:`conv_int8_work` count
the work of the route as it runs (the max pass only where it runs; the
residual read and the max's slot).  The yardsticks that ``chip_smoke.py``
times beside I2, and that the port never calls: ``torch._int_mm`` over an
im2col of the quantized input, and cuDNN's bf16 ``F.conv2d`` of the same
shape.  The design, and what bounds it, is in the source's header.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lpr_tpu_torch.kernels import refuse_export
from lpr_tpu_torch.ops import nn as tnn

Tensor = torch.Tensor

K_STEP = 32          # int8 channels a wgmma k-step (m64nNk32): Cin pads to it
N_PAD = 128          # the pack pads Cout to I2's widest N tile
BM = 128             # I2's output positions a tile (two warpgroups of 64)
TMA_ROWS = 64        # weight rows (output channels) a TMA box
SMS = 132            # streaming multiprocessors of an H100 SXM
KERNEL_SIZES = (1, 3, 5)
STRIDES = (1, 2)
ACTS = ("none", "silu", "leaky")   # I2's act instances, in template order
# Elementwise float32 rate outside the tensor cores (H100 SXM data sheet),
# for I1's operations; I2's are int8 on the tensor cores.
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
_OUT_TYPES = {"acc": 0, torch.bfloat16: 1, torch.float32: 2}


def padded_channels(c: int) -> int:
    """Channels of a quantized activation: ``c`` rounded up to a k-step."""
    return -(-int(c) // K_STEP) * K_STEP


def k_stage(cp: int) -> int:
    """Channels of one tap that one stage of I2's ring holds: 128 where Cp
    allows, else 64, else 32 (one to four 32-byte wgmma k-steps)."""
    return next(k for k in (128, 64, 32) if cp % k == 0)


def tile_shape(ho: int, wo: int, stride: int = 1) -> Tuple[int, int]:
    """(tw, th): I2's output tile, th rows of tw positions of one image (at
    most :data:`BM` positions; a TMA box spans tw * stride <= 256 input
    columns), the one that wastes the fewest of the tiles' rows (ties: the
    wider)."""
    widths = [w for w in (wo, 128, 64, 32, 16, 8)
              if w <= BM and w * stride <= 256]

    def waste(tw):
        th = max(1, min(BM // tw, ho, 256 // stride))
        return -(-wo // tw) * -(-ho // th) * BM, -tw, th

    best = min(widths, key=waste)
    return best, waste(best)[2]


def n_tile(tiles: int, cout: int) -> int:
    """I2's N tile for ``tiles`` output tiles and Cout channels: 128 where
    that still gives every SM a block, else 64."""
    if cout > 64 and tiles * -(-cout // 128) >= SMS:
        return 128
    return 64


def act_amax_plain(x: Tensor) -> Tensor:
    """The max pass's plain version: max|x| over the whole tensor, float32,
    shape ()."""
    return x.float().abs().amax()


def quantize_act_plain(x: Tensor, amax: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor]:
    """The quantize's plain version: NHWC float ``x`` -> (int8 (B, H, W,
    Cp), float32 sx (1,)), the JAX function's float32 operations in its
    order; ``amax`` (float32) in place of the tensor's own max|x|."""
    xf = x.float()
    m = xf.abs().amax() if amax is None else amax.float().reshape(())
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds apart from m / 127
    sx = torch.clamp_min(m / torch.full_like(m, 127.0), 1e-12).reshape(1)
    q = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    cp = padded_channels(x.shape[-1])
    return F.pad(q, (0, cp - int(x.shape[-1]))), sx


def int8_pack(w_q) -> Tensor:
    """An HWIO int8 weight (tensor or array) as I2's TMA reads it: the
    (Np, K) K-major matrix, int8, on the tensor's device, with row n the
    output channel n and K = kh * kw * Cp over (tap, channel), the
    channels padded to :func:`padded_channels`, Np = Cout padded to
    :data:`N_PAD`, zeros in the padding.  A TMA box of it is 64 rows of one
    stage's k-steps (:func:`weight_map`)."""
    dev = w_q.device if isinstance(w_q, Tensor) else torch.device("cpu")
    w = np.asarray(w_q.cpu() if isinstance(w_q, Tensor) else w_q, np.int8)
    kh, kw, cin, cout = w.shape
    cp, npad = padded_channels(cin), -(-cout // N_PAD) * N_PAD
    bm = np.zeros((npad, kh * kw, cp), np.int8)
    bm[:cout, :, :cin] = w.reshape(kh * kw, cin, cout).transpose(2, 0, 1)
    return torch.from_numpy(bm.reshape(npad, -1)).to(dev)


def _out_hw(h: int, w: int, kh: int, kw: int, stride, pad) -> Tuple[int, int]:
    return ((h + 2 * pad[0] - kh) // stride[0] + 1,
            (w + 2 * pad[1] - kw) // stride[1] + 1)


def conv_int8_plain(xq: Tensor, sx: Tensor, w_q: Tensor, w_s: Tensor,
                    b: Optional[Tensor], *, stride=(1, 1), padding=(0, 0),
                    groups: int = 1, out_dtype=torch.float32,
                    raw: bool = False, act: str = "none",
                    residual: Optional[Tensor] = None) -> Tensor:
    """I2's plain version: the int32 sums taken exactly in float64
    (127 * 127 * K < 2^53; float32 would round once K > ~1,040), then the
    epilogue in float32 as the JAX function: ``acc * (sx * w_s)``, ``+ b``,
    rounded to ``out_dtype``; then ``ops.nn.act`` and ``residual + y``,
    as ``ConvAct`` and ``Bottleneck`` compose them.  With ``raw`` the sums
    as int32."""
    cin = int(w_q.shape[2]) * groups
    x = xq[..., :cin].permute(0, 3, 1, 2).to(torch.float64)
    acc = F.conv2d(x, w_q.permute(3, 2, 0, 1).to(torch.float64),
                   stride=tuple(stride), padding=tuple(padding),
                   groups=groups).permute(0, 2, 3, 1)
    if raw:
        return acc.to(torch.int32).contiguous()
    out = acc.to(torch.float32) * (sx * w_s)
    if b is not None:
        out = out + b.to(torch.float32)
    y = tnn.act(out.to(out_dtype), act)
    if residual is not None:
        y = residual + y
    return y.contiguous()


def bind(lib: ctypes.CDLL):
    """I1's and I2's functions in a library built from
    ``csrc/conv_int8.cu``, with their argument types: ({dtype: max pass},
    {dtype: quantize}, conv, tensor-map encoder)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    amax = {torch.bfloat16: lib.lpr_act_amax_bf16,
            torch.float32: lib.lpr_act_amax_f32}
    for fn in amax.values():
        fn.argtypes = [ptr, i64, ptr, ptr]
        fn.restype = i32
    quant = {torch.bfloat16: lib.lpr_quantize_act_bf16,
             torch.float32: lib.lpr_quantize_act_f32}
    for fn in quant.values():
        fn.argtypes = [ptr, i64, i32, i32, ptr, ptr] + [ptr] * 4 + [i32, ptr]
        fn.restype = i32
    conv = lib.lpr_conv_int8
    conv.argtypes = [ptr] * 8 + [i32] * 18 + [ptr]
    conv.restype = i32
    tmap = lib.lpr_conv_int8_tmap
    tmap.argtypes = [ptr, i64, i32, i32, ptr]
    tmap.restype = i32
    return amax, quant, conv, tmap


@functools.cache
def _launchers():
    from lpr_tpu_torch.kernels._build import library

    return bind(library("conv_int8"))


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_act(x: Tensor, name: str) -> Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise ValueError(f"{name} takes a 4-D bf16 or float32 NHWC tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def _check_slot(s: Tensor, dev) -> None:
    if (s.device != dev or s.dtype != torch.float32 or s.numel() != 1
            or s.data_ptr() % 4):
        raise ValueError(f"an amax slot is one float32 element on {dev}")


def act_amax(x: Tensor, slot: Tensor) -> None:
    """I1's max pass: ``slot = max(slot, max|x|)`` over the whole NHWC
    tensor.  ``slot``: one float32 element, >= 0 (zeroed before the first
    max into it).  A CUDA tensor launches the kernel on the current stream
    (the blocks meet in one ``atomicMax`` on the float's bits: exact, a max
    does not depend on order), or raises; a CPU tensor takes
    :func:`act_amax_plain`."""
    refuse_export("act_amax")
    if x.device.type == "cpu":
        slot.copy_(torch.maximum(slot.reshape(()), act_amax_plain(x))
                   .reshape(slot.shape))
        return
    x = _check_act(x, "act_amax")
    _check_slot(slot, x.device)
    amax, _, _, _ = _launchers()
    with torch.cuda.device(x.device):
        err = amax[x.dtype](x.data_ptr(), x.numel(), slot.data_ptr(),
                            _stream(x))
    if err != 0:
        raise RuntimeError(f"act_amax launch failed: cudaError {err}")
    act_amax.launches += 1


act_amax.launches = 0


def quantize_act(x: Tensor, slots: Optional[Sequence[Tensor]] = None
                 ) -> Tuple[Tensor, Tensor]:
    """I1 on an NHWC activation -> (int8 (B, H, W, Cp), float32 sx (1,) on
    the same device).  ``slots``: 1-4 float32 slots whose max is max|x|
    (what the layers that wrote ``x`` carried); None runs the max pass
    (:func:`act_amax`) into a zeroed slot first.  A CUDA tensor (bf16 or
    float32; made contiguous) launches the quantize on the current stream,
    or raises; a CPU tensor takes :func:`quantize_act_plain`."""
    refuse_export("quantize_act")
    if slots is None:
        slot = torch.zeros((1,), dtype=torch.float32, device=x.device)
        act_amax(x, slot)
        slots = [slot]
    if not 1 <= len(slots) <= 4:
        raise ValueError(f"quantize_act reads 1-4 slots, got {len(slots)}")
    if x.device.type == "cpu":
        amax = torch.stack([s.reshape(()) for s in slots]).amax()
        return quantize_act_plain(x, amax)
    x = _check_act(x, "quantize_act")
    for s in slots:
        _check_slot(s, x.device)
    c = int(x.shape[-1])
    cp = padded_channels(c)
    xq = torch.empty((*x.shape[:-1], cp), dtype=torch.int8, device=x.device)
    sx = torch.empty((1,), dtype=torch.float32, device=x.device)
    ptrs = [s.data_ptr() for s in slots] + [None] * (4 - len(slots))
    _, quant, _, _ = _launchers()
    with torch.cuda.device(x.device):
        err = quant[x.dtype](x.data_ptr(), x.numel() // c, c, cp,
                             xq.data_ptr(), sx.data_ptr(), *ptrs,
                             len(slots), _stream(x))
    if err != 0:
        raise RuntimeError(f"quantize_act launch failed: cudaError {err}")
    quantize_act.launches += 1
    return xq, sx


quantize_act.launches = 0

# TMA descriptors by (address, K, Np, k-steps a stage) of the packed
# weight: equal keys encode equal descriptors, so a weight that moved is
# simply encoded anew.
_MAPS: dict = {}


def weight_map(packed: Tensor, cin: int) -> ctypes.Array:
    """The TMA descriptor (a ``CUtensorMap``, 128 bytes) of a packed weight
    of ``cin`` input channels on a card (:func:`int8_pack`): the (Np, K)
    int8 matrix, boxes of 64 rows x one stage's k_stage(Cp) bytes, in the
    swizzle of that width that I2's wgmma descriptors read.  Encoded once
    per weight (cached by its address and shape)."""
    np_, k = (int(n) for n in packed.shape)
    ka = k_stage(padded_channels(cin)) // K_STEP
    key = (packed.data_ptr(), k, np_, ka)
    if key not in _MAPS:
        buf = ctypes.create_string_buffer(128)
        _, _, _, tmap = _launchers()
        with torch.cuda.device(packed.device):
            err = tmap(packed.data_ptr(), k, np_, ka, buf)
        if err != 0:
            raise RuntimeError(f"cuTensorMapEncodeTiled failed: {err}")
        _MAPS[key] = buf
    return _MAPS[key]


def conv_int8(xq: Tensor, sx: Tensor, w_q: Tensor, w_s: Tensor,
              b: Optional[Tensor], *, stride=(1, 1), padding=(0, 0),
              groups: int = 1, out_dtype=torch.float32,
              packed: Optional[Tensor] = None, raw: bool = False,
              act: str = "none", residual: Optional[Tensor] = None,
              amax: Optional[Tensor] = None) -> Tensor:
    """I2: the quantized activation ``xq`` (B, H, W, Cp) of scale ``sx``
    convolved with the HWIO int8 weight ``w_q`` of per-Cout scales ``w_s``
    and bias ``b`` (float32, or None) -> (B, Ho, Wo, Cout) in ``out_dtype``
    (bf16 or float32), then ``act`` (:data:`ACTS`) and ``residual + y``
    (``residual``: that shape and dtype); with ``amax`` (a float32 slot)
    the max|y| of what it stores is taken into the slot.  With ``raw`` the
    int32 sums (no act, residual or amax).

    A CUDA tensor launches the kernel on the current stream with
    ``packed`` (:func:`int8_pack` of ``w_q``), or raises; a CPU tensor takes
    :func:`conv_int8_plain` (and :func:`act_amax` for ``amax``)."""
    refuse_export("conv_int8")
    stride, padding = tuple(stride), tuple(padding)
    if act not in ACTS:
        raise ValueError(f"conv_int8's act must be one of {ACTS}, got {act!r}")
    if raw and (act != "none" or residual is not None or amax is not None):
        raise ValueError("conv_int8 with raw writes the sums alone")
    if xq.device.type == "cpu":
        y = conv_int8_plain(xq, sx, w_q, w_s, b, stride=stride,
                            padding=padding, groups=groups,
                            out_dtype=out_dtype, raw=raw, act=act,
                            residual=residual)
        if amax is not None:
            act_amax(y, amax)
        return y
    dev = xq.device
    kh, kw, cig, cout = (int(n) for n in w_q.shape)
    if groups != 1:
        raise ValueError(f"conv_int8 takes groups == 1, got {groups}")
    if kh not in KERNEL_SIZES or kw not in KERNEL_SIZES:
        raise ValueError(f"conv_int8 takes kernels {KERNEL_SIZES}, got "
                         f"{(kh, kw)}")
    if stride[0] != stride[1] or stride[0] not in STRIDES:
        raise ValueError(f"conv_int8 takes strides {STRIDES}, got {stride}")
    if min(padding) < 0:
        raise ValueError(f"conv_int8 takes padding >= 0, got {padding}")
    cp = padded_channels(cig)
    if (xq.dtype != torch.int8 or xq.dim() != 4 or not xq.is_contiguous()
            or xq.shape[-1] != cp or xq.data_ptr() % 16):
        raise ValueError(f"conv_int8 takes quantize_act's contiguous int8 "
                         f"(B, H, W, {cp}), got {xq.dtype} "
                         f"{tuple(xq.shape)}")
    npad = -(-cout // N_PAD) * N_PAD
    for name, t, dt, shape in (("sx", sx, torch.float32, (1,)),
                               ("w_s", w_s, torch.float32, (cout,)),
                               ("b", b, torch.float32, (cout,)),
                               ("packed", packed, torch.int8,
                                (npad, kh * kw * cp))):
        if name == "b" and t is None:
            continue
        if (t is None or t.device != dev or t.dtype != dt
                or t.numel() != math.prod(shape) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"conv_int8's {name} must be a contiguous, "
                             f"16-byte aligned {dt} tensor of shape {shape} "
                             f"on {dev}")
    if raw:
        out_dtype = "acc"
    elif out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv_int8 writes bf16 or float32, not {out_dtype}")
    B, H, W, _ = (int(n) for n in xq.shape)
    ho, wo = _out_hw(H, W, kh, kw, stride, padding)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"conv_int8: empty output {(ho, wo)}")
    tw, th = tile_shape(ho, wo, stride[0])
    tiles = B * -(-wo // tw) * -(-ho // th)
    out = torch.empty((B, ho, wo, cout), device=dev, dtype=(
        torch.int32 if raw else out_dtype))
    if residual is not None and (residual.shape != out.shape
                                 or residual.dtype != out.dtype
                                 or residual.device != dev
                                 or not residual.is_contiguous()
                                 or residual.data_ptr() % 16):
        raise ValueError(f"conv_int8's residual must be a contiguous, "
                         f"16-byte aligned {out.dtype} tensor of shape "
                         f"{tuple(out.shape)}")
    if amax is not None:
        _check_slot(amax, dev)
    tmap = weight_map(packed, cig)
    _, _, conv, _ = _launchers()
    with torch.cuda.device(dev):
        err = conv(ctypes.addressof(tmap), xq.data_ptr(), sx.data_ptr(),
                   w_s.data_ptr(), None if b is None else b.data_ptr(),
                   None if residual is None else residual.data_ptr(),
                   out.data_ptr(), None if amax is None else amax.data_ptr(),
                   _OUT_TYPES[out_dtype], n_tile(tiles, cout),
                   ACTS.index(act), k_stage(cp) // K_STEP, tw, th, B, H, W,
                   cp, ho, wo, cout, kh, kw, stride[0], padding[0],
                   padding[1], _stream(xq))
    if err != 0:
        raise RuntimeError(f"conv_int8 launch failed: cudaError {err}")
    conv_int8.launches += 1
    return out


conv_int8.launches = 0


class QuantizedAct(NamedTuple):
    """An activation with its I1 codes and scale, for the convs that read
    the same tensor (a C3's ``cv1`` and ``cv2``) to share one quantize."""

    x: Tensor
    xq: Tensor
    sx: Tensor


def amax_work(shape, itemsize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of I1's max pass on an NHWC activation of
    ``shape``: |x| and a compare a value; the activation read once, the
    slot written."""
    n = math.prod(int(s) for s in shape)
    return 2 * n, n * itemsize + 4


def quantize_work(shape, itemsize: int = 2, slots: int = 1
                  ) -> Tuple[int, int]:
    """(operations, bytes) of I1's quantize on an NHWC activation of
    ``shape``: the divide, round and clamp, 3 a value; the slots and the
    activation read once, the padded int8 codes and sx written once."""
    n = math.prod(int(s) for s in shape)
    c = int(shape[-1])
    return 3 * n, 4 * slots + n * itemsize + (n // c) * padded_channels(c) + 4


def conv_int8_work(x_shape, w_shape, stride=(1, 1), padding=(0, 0),
                   out_itemsize: int = 2, residual: bool = False,
                   amax: bool = False) -> Tuple[int, int]:
    """(int8 operations, bytes) of I2: 2 x multiply-adds at the exact
    output size over the true K = kh * kw * Cin; the int8 input (Cin
    channels), weight, the float32 scales and bias and sx read once, the
    residual (if any) read once, the output written once, the max's slot
    (if any) written."""
    B, H, W, cin = (int(n) for n in x_shape)
    kh, kw, _, cout = (int(n) for n in w_shape)
    ho, wo = _out_hw(H, W, kh, kw, tuple(stride), tuple(padding))
    ops = 2 * B * ho * wo * cout * kh * kw * cin
    out_bytes = B * ho * wo * cout * out_itemsize
    nbytes = (B * H * W * cin + kh * kw * cin * cout + 8 * cout + 4
              + out_bytes * (2 if residual else 1) + (4 if amax else 0))
    return ops, nbytes
