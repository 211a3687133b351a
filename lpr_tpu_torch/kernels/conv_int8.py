"""I1 and I2: the int8 convolution of the quantized plate detector, the
port of ``lpr_tpu/ops/nn.py:129`` ``conv2d_int8`` (``lax.conv`` on int8
operands, not a Pallas kernel; PyTorch has no int8 convolution on CUDA).

- :func:`quantize_act` (I1) — the whole tensor's max|x| (the batch
  included), ``sx = max(amax / 127, 1e-12)``, ``xq = clamp(rint(x / sx),
  -127, 127)`` as int8 NHWC, channels padded with zeros to a multiple of
  32 (:func:`padded_channels`).  A CUDA tensor launches the kernels in
  ``lpr_tpu_torch/csrc/conv_int8.cu`` (a max across blocks by
  ``atomicMax`` on the float's bits, then the quantize; sx stays on the
  device) or raises; a CPU tensor takes :func:`quantize_act_plain`.
  Counted in ``quantize_act.launches``.
- :func:`conv_int8` (I2) — the implicit-GEMM convolution on
  ``mma.sync`` m16n8k32 s8 -> s32, then the JAX function's float32
  epilogue ``float(acc) * (sx * w_s) + b``, rounded to the output dtype
  (or, with ``raw``, the int32 sums).  It takes ``groups == 1``, kernels 1,
  3 and 5, stride 1 or 2, any Cin; a CUDA launch of anything else raises.
  The weight comes as :func:`int8_pack`'s fragments, packed once at load.
  A CPU tensor takes :func:`conv_int8_plain`.  Counted in
  ``conv_int8.launches``.

Bounds on an H100 SXM: I1 is bound by bytes (3.35 TB/s), I2 by int8
operations (1,979 TOPS dense) or bytes; :func:`quantize_work` and
:func:`conv_int8_work` count them.  The yardsticks that ``chip_smoke.py``
times beside I2, and that the port never calls: ``torch._int_mm`` over an
im2col of the quantized input, and cuDNN's bf16 ``F.conv2d`` of the same
shape.  I2 is a simple first kernel (the design is in the source's
header); ``wgmma`` and fusing I1's max into the previous layer are later
work.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

K_STEP = 32          # int8 channels a k-step of I2 (mma m16n8k32)
N_BLOCK = 64         # I2's output channels a block; the pack pads Cout to it
KERNEL_SIZES = (1, 3, 5)
STRIDES = (1, 2)
# Elementwise float32 rate outside the tensor cores (H100 SXM data sheet),
# for I1's operations; I2's are int8 on the tensor cores.
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12


def padded_channels(c: int) -> int:
    """Channels of a quantized activation: ``c`` rounded up to a k-step."""
    return -(-int(c) // K_STEP) * K_STEP


def quantize_act_plain(x: Tensor) -> Tuple[Tensor, Tensor]:
    """I1's plain version: NHWC float ``x`` -> (int8 (B, H, W, Cp), float32
    sx (1,)), the JAX function's float32 operations in its order."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax() / 127.0, 1e-12).reshape(1)
    q = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    cp = padded_channels(x.shape[-1])
    return F.pad(q, (0, cp - int(x.shape[-1]))), sx


def int8_pack(w_q) -> Tensor:
    """An HWIO int8 weight (tensor or array) as I2 reads it, int8, flat, on
    the tensor's device: the K x N matrix (K over (tap, channel) with the
    channels padded to :func:`padded_channels`, N padded to a multiple of
    :data:`N_BLOCK`, zeros in the padding) cut into k-steps of 32; per
    k-step s, per n-tile pair p, per lane l, 16 bytes = (b0, b1) of n-tile
    2p then of 2p + 1, where b0 holds B[32s + 4(l%4) + e][8nt + l/4] for
    e = 0..3 (lowest byte first) and b1 the same 16 rows down: the
    mma.m16n8k32 s8 B fragment of lane l."""
    dev = w_q.device if isinstance(w_q, Tensor) else torch.device("cpu")
    w = np.asarray(w_q.cpu() if isinstance(w_q, Tensor) else w_q, np.int8)
    kh, kw, cin, cout = w.shape
    cp, npad = padded_channels(cin), -(-cout // N_BLOCK) * N_BLOCK
    bm = np.zeros((kh * kw, cp, npad), np.int8)
    bm[:, :cin, :cout] = w.reshape(kh * kw, cin, cout)
    bm = bm.reshape(-1, K_STEP, npad)
    s = np.arange(bm.shape[0])[:, None, None, None, None]
    pair = np.arange(npad // 16)[None, :, None, None, None]
    lane = np.arange(32)[None, None, :, None, None]
    word = np.arange(4)[None, None, None, :, None]
    e = np.arange(4)[None, None, None, None, :]
    k = 16 * (word % 2) + 4 * (lane % 4) + e
    n = 8 * (2 * pair + word // 2) + lane // 4
    frag = np.ascontiguousarray(bm[s, k, n]).reshape(-1)
    return torch.from_numpy(frag).to(dev)


def _out_hw(h: int, w: int, kh: int, kw: int, stride, pad) -> Tuple[int, int]:
    return ((h + 2 * pad[0] - kh) // stride[0] + 1,
            (w + 2 * pad[1] - kw) // stride[1] + 1)


def conv_int8_plain(xq: Tensor, sx: Tensor, w_q: Tensor, w_s: Tensor,
                    b: Optional[Tensor], *, stride=(1, 1), padding=(0, 0),
                    groups: int = 1, out_dtype=torch.float32,
                    raw: bool = False) -> Tensor:
    """I2's plain version: the int32 sums taken exactly in float64
    (127 * 127 * K < 2^53; float32 would round once K > ~1,040), then the
    epilogue in float32 as the JAX function: ``acc * (sx * w_s)``, ``+ b``,
    rounded to ``out_dtype``; with ``raw`` the sums as int32."""
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
    return out.to(out_dtype).contiguous()


def bind(lib: ctypes.CDLL):
    """I1's and I2's launchers in a library built from
    ``csrc/conv_int8.cu``, with their argument types: ({dtype: quantize},
    {dtype or "acc": conv})."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    quant = {torch.bfloat16: lib.lpr_quantize_act_bf16,
             torch.float32: lib.lpr_quantize_act_f32}
    for fn in quant.values():
        fn.argtypes = [ptr, i64, i32, i32, ptr, ptr, ptr, ptr]
        fn.restype = i32
    conv = {torch.bfloat16: lib.lpr_conv_int8_bf16,
            torch.float32: lib.lpr_conv_int8_f32,
            "acc": lib.lpr_conv_int8_acc}
    for fn in conv.values():
        fn.argtypes = [ptr] * 6 + [i32] * 13 + [ptr]
        fn.restype = i32
    return quant, conv


@functools.cache
def _launchers():
    from lpr_tpu_torch.kernels._build import library

    return bind(library("conv_int8"))


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_act(x: Tensor) -> Tuple[Tensor, Tensor]:
    """I1 on an NHWC activation -> (int8 (B, H, W, Cp), float32 sx (1,) on
    the same device).  A CUDA tensor (bf16 or float32; made contiguous)
    launches the kernels on the current stream, or raises; a CPU tensor
    takes :func:`quantize_act_plain`."""
    if x.device.type == "cpu":
        return quantize_act_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_act runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise ValueError(f"quantize_act takes a 4-D bf16 or float32 NHWC "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    c = int(x.shape[-1])
    cp = padded_channels(c)
    xq = torch.empty((*x.shape[:-1], cp), dtype=torch.int8, device=x.device)
    sx = torch.empty((1,), dtype=torch.float32, device=x.device)
    amax = torch.empty((1,), dtype=torch.int32, device=x.device)
    quant, _ = _launchers()
    with torch.cuda.device(x.device):
        err = quant[x.dtype](x.data_ptr(), x.numel() // c, c, cp,
                             xq.data_ptr(), sx.data_ptr(), amax.data_ptr(),
                             _stream(x))
    if err != 0:
        raise RuntimeError(f"quantize_act launch failed: cudaError {err}")
    quantize_act.launches += 1
    return xq, sx


quantize_act.launches = 0


def conv_int8(xq: Tensor, sx: Tensor, w_q: Tensor, w_s: Tensor,
              b: Optional[Tensor], *, stride=(1, 1), padding=(0, 0),
              groups: int = 1, out_dtype=torch.float32,
              packed: Optional[Tensor] = None, raw: bool = False) -> Tensor:
    """I2: the quantized activation ``xq`` (B, H, W, Cp) of scale ``sx``
    convolved with the HWIO int8 weight ``w_q`` of per-Cout scales ``w_s``
    and bias ``b`` (float32, or None) -> (B, Ho, Wo, Cout) in ``out_dtype``
    (bf16 or float32), or with ``raw`` the int32 sums.

    A CUDA tensor launches the kernel on the current stream with
    ``packed`` (:func:`int8_pack` of ``w_q``), or raises; a CPU tensor takes
    :func:`conv_int8_plain`."""
    stride, padding = tuple(stride), tuple(padding)
    if xq.device.type == "cpu":
        return conv_int8_plain(xq, sx, w_q, w_s, b, stride=stride,
                               padding=padding, groups=groups,
                               out_dtype=out_dtype, raw=raw)
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
    if (xq.dtype != torch.int8 or xq.dim() != 4 or not xq.is_contiguous()
            or xq.shape[-1] != padded_channels(cig)
            or xq.data_ptr() % 16):
        raise ValueError(f"conv_int8 takes quantize_act's contiguous int8 "
                         f"(B, H, W, {padded_channels(cig)}), got {xq.dtype} "
                         f"{tuple(xq.shape)}")
    npad = -(-cout // N_BLOCK) * N_BLOCK
    n_frag = kh * kw * padded_channels(cig) * npad
    for name, t, dt, n in (("sx", sx, torch.float32, 1),
                           ("w_s", w_s, torch.float32, cout),
                           ("b", b, torch.float32, cout),
                           ("packed", packed, torch.int8, n_frag)):
        if name == "b" and t is None:
            continue
        if (t is None or t.device != dev or t.dtype != dt or t.numel() != n
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"conv_int8's {name} must be a contiguous, "
                             f"16-byte aligned {dt} tensor of {n} elements "
                             f"on {dev}")
    if raw:
        out_dtype = torch.int32
    elif out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv_int8 writes bf16 or float32, not {out_dtype}")
    B, H, W, cp = (int(n) for n in xq.shape)
    ho, wo = _out_hw(H, W, kh, kw, stride, padding)
    out = torch.empty((B, ho, wo, cout), dtype=out_dtype, device=dev)
    _, conv = _launchers()
    with torch.cuda.device(dev):
        err = conv["acc" if raw else out_dtype](
            xq.data_ptr(), packed.data_ptr(), sx.data_ptr(), w_s.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), B, H, W, cp,
            ho, wo, cout, npad, kh, kw, stride[0], padding[0], padding[1],
            _stream(xq))
    if err != 0:
        raise RuntimeError(f"conv_int8 launch failed: cudaError {err}")
    conv_int8.launches += 1
    return out


conv_int8.launches = 0


def quantize_work(shape, itemsize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of I1 on an NHWC activation of ``shape``: the
    max's |x| and compare and the quantize's divide and round, 4 a value;
    the activation read once (``itemsize`` bytes a value) and the padded
    int8 codes and sx written once."""
    n = math.prod(int(s) for s in shape)
    c = int(shape[-1])
    return 4 * n, n * itemsize + (n // c) * padded_channels(c) + 4


def conv_int8_work(x_shape, w_shape, stride=(1, 1), padding=(0, 0),
                   out_itemsize: int = 2) -> Tuple[int, int]:
    """(int8 operations, bytes) of I2: 2 x multiply-adds at the exact
    output size over the true K = kh * kw * Cin; the int8 input (Cin
    channels), weight, the float32 scales and bias read once, the output
    written once."""
    B, H, W, cin = (int(n) for n in x_shape)
    kh, kw, _, cout = (int(n) for n in w_shape)
    ho, wo = _out_hw(H, W, kh, kw, tuple(stride), tuple(padding))
    ops = 2 * B * ho * wo * cout * kh * kw * cin
    nbytes = (B * H * W * cin + kh * kw * cin * cout + 8 * cout + 4
              + B * ho * wo * cout * out_itemsize)
    return ops, nbytes
