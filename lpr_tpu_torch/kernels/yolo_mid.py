"""K3: the plate detector's layers 3-4 as one kernel, the port of
``lpr_tpu/ops/pallas/yolo_mid.py`` ``mid_fused``.

- :func:`mid_pack` — the weight packer (counterpart of
  ``mid_pack_from_params``): checks the layer pattern and gathers the
  detector's BN-folded weights, with C3's cv1 and cv2 joined into one
  128->128 1x1; :func:`mid_pack_folded` packs folded HWIO arrays.  Besides
  the float32 weights, the kernel's operands: each layer's weight as bf16
  mma B fragments (:data:`MMA_LAYERS`) and the biases in one buffer.
- :func:`yolo_mid` — the wrapper.  A CUDA tensor goes to the kernel in
  ``lpr_tpu_torch/csrc/yolo_mid.cu`` (built with nvcc, loaded with ctypes)
  or raises; only a CPU tensor takes the plain version.
- :func:`mid_plain` — the same function as a chain of ``F.conv2d`` + SiLU,
  reading the same packed weights and rounding where the kernel rounds.

The TPU kernel's parity-plane repack of its input (``pack_mid_input``) is
TPU layout and is not carried over: the kernel reads K1's NHWC output and
splits it into parity planes itself, in shared memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lpr_tpu_torch.kernels import refuse_export
from lpr_tpu_torch.kernels.yolo_front import FrontPacked, b_frags
from lpr_tpu_torch.ops.nn import silu

Tensor = torch.Tensor

# How close K3 must come to mid_plain in bf16: the JAX kernel test's bounds
# (tests/test_pallas_mid.py: max 0.05, interior mean 0.006) plus two bf16
# ulps relative, as K1 needed with real weights (both round at the same
# points and differ only by one-ulp flips of float32 sums taken in another
# order, which the later layers carry on).
TOL_ABS = 0.05
TOL_REL = 2.0 ** -7
TOL_INTERIOR_MEAN = 0.006

# The kernel's GEMM operands, in the order of packed["mma"]: per layer its
# weight key, k-steps (taps x 16-channel input chunks) and output channels.
# Each weight is a K x N matrix, K = 16 * k-steps running over (tap,
# chunk, channel) of the HWIO (or (cin, cout)) weight, written as bf16
# mma.m16n8k16 B fragments (:func:`lpr_tpu_torch.kernels.yolo_front.b_frags`).
# The biases follow BIAS_KEYS in packed["bias"].
MMA_LAYERS = (("w3", 36, 128), ("w12", 8, 128), ("wa1", 4, 64),
              ("wa2", 36, 64), ("wb1", 4, 64), ("wb2", 36, 64),
              ("w3o", 8, 128))
BIAS_KEYS = ("b3", "b12", "ba1", "ba2", "bb1", "bb2", "b3o")
MMA_ELEMS = sum(ks * 16 * n for _, ks, n in MMA_LAYERS)     # 188,416
BIAS_ELEMS = 640


class MidPacked(FrontPacked):
    """:func:`mid_pack`'s tensors by key, and ``bf16_exact``: whether the
    bf16 B fragments hold the float32 weights exactly, which the kernel
    needs."""


def mid_geom(h4: int, w4: int) -> Tuple[int, int]:
    """Output grid (h4/2, w4/2) below a (h4, w4) front-output grid (H/4,
    W/4); the kernel masks a ragged last tile, so it takes any even grid
    and raises otherwise."""
    if h4 % 2 or w4 % 2 or h4 <= 0 or w4 <= 0:
        raise ValueError(f"fused mid needs an even front grid, got "
                         f"{(h4, w4)}")
    return h4 // 2, w4 // 2


def mid_pack_folded(p_l3: Dict, p_c3: Dict, device=None) -> MidPacked:
    """Packed weights from BN-folded HWIO arrays (numpy or tensors), the
    arguments of ``lpr_tpu``'s ``pack_mid_weights``: ``p_l3`` {w (3,3,64,128),
    b}; ``p_c3`` cv1, cv2 (1,1,128,64), cv3 (1,1,128,128), m: two of
    {cv1 (1,1,64,64), cv2 (3,3,64,64)}.

    fp32 tensors: HWIO ``w3``, ``wa2``, ``wb2``; (cin, cout) ``w12`` (cv1 in
    output channels 0-63, cv2 in 64-127), ``wa1``, ``wb1``, ``w3o``; biases
    (cout,).  For the kernel: ``mma``, the seven weights' bf16 B fragments
    in :data:`MMA_LAYERS` order, and ``bias``, the biases in
    :data:`BIAS_KEYS` order (fp32); ``bf16_exact`` tells whether every
    weight is representable in bf16 (as a bf16 model's are)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32) if not
                               isinstance(a, Tensor) else a).float()

    def mat(p):
        return t(p["w"])[0, 0]

    m0, m1 = p_c3["m"]
    packed = {
        "w3": t(p_l3["w"]), "b3": t(p_l3["b"]),
        "w12": torch.cat([mat(p_c3["cv1"]), mat(p_c3["cv2"])], 1),
        "b12": torch.cat([t(p_c3["cv1"]["b"]), t(p_c3["cv2"]["b"])]),
        "wa1": mat(m0["cv1"]), "ba1": t(m0["cv1"]["b"]),
        "wa2": t(m0["cv2"]["w"]), "ba2": t(m0["cv2"]["b"]),
        "wb1": mat(m1["cv1"]), "bb1": t(m1["cv1"]["b"]),
        "wb2": t(m1["cv2"]["w"]), "bb2": t(m1["cv2"]["b"]),
        "w3o": mat(p_c3["cv3"]), "b3o": t(p_c3["cv3"]["b"]),
    }
    packed = {k: v.to(device) for k, v in packed.items()}
    exact = all(torch.equal(packed[k].to(torch.bfloat16).float(), packed[k])
                for k, _, _ in MMA_LAYERS)
    packed["mma"] = torch.cat([b_frags(packed[k].reshape(-1, n))
                               for k, _, n in MMA_LAYERS])
    packed["bias"] = torch.cat([packed[k] for k in BIAS_KEYS])
    # own allocations: the kernel reads 16-byte vectors from each base
    return MidPacked({k: v.contiguous().clone() for k, v in packed.items()},
                     bool(exact))


def mid_pack(model) -> MidPacked:
    """Packed layer 3-4 weights of a
    :class:`~lpr_tpu_torch.models.yolo.YoloModel` whose layer 3 is
    Conv(64->128, k3, s2) and layer 4 C3(128->128, n=2, shortcut), both
    sequential, layer 3 read by no other layer (layer 4 may be: the kernel
    writes its whole output); raises ValueError otherwise (where the JAX
    packer returns None).  Holds the model's own values on its device (so
    a bf16 model packs bf16-representable weights)."""
    from lpr_tpu_torch.models.yolo import C3, Conv

    ls = model.layers
    l3, l4 = (ls[3], ls[4]) if len(ls) >= 5 else (None, None)
    ok = (type(l3) is Conv and l3.k == 3 and l3.s == 2 and l3.c1 == 64
          and l3.c2 == 128 and l3.g == 1 and l3.act == "silu"
          and type(l4) is C3 and l4.n == 2 and l4.shortcut and l4.c1 == 128
          and l4.c2 == 128 and l4.g == 1 and l4.e == 0.5
          and l3.f == -1 and l4.f == -1 and 3 not in model.save)
    if not ok:
        raise ValueError("layers 3-4 do not match the fused mid pattern")

    def folded(conv_act):
        c = conv_act.conv
        return {"w": c.w.float().permute(2, 3, 1, 0), "b": c.b.float()}

    p_c3 = {"cv1": folded(l4.cv1), "cv2": folded(l4.cv2),
            "cv3": folded(l4.cv3),
            "m": [{"cv1": folded(b.cv1), "cv2": folded(b.cv2)}
                  for b in l4.m]}
    return mid_pack_folded(folded(l3.cv), p_c3, device=l3.cv.conv.w.device)


def mid_plain(y: Tensor, packed: Dict[str, Tensor]) -> Tensor:
    """The plain PyTorch version: front output (B, H4, W4, 64) ->
    (B, H4/2, W4/2, 128) in ``y``'s dtype.

    It rounds where the kernel rounds: each conv, its bias and SiLU in
    float32 over the stored inputs, each layer's output stored in ``y``'s
    dtype, each residual sum rounded once.  For float32 input that is a
    plain float32 chain."""
    dt = y.dtype
    p = packed

    def conv(z, w, b, stride=1):
        if w.dim() == 2:
            w = w[None, None]
        out = F.conv2d(z.float(), w.permute(3, 2, 0, 1).float(), b.float(),
                       stride=stride, padding=w.shape[0] // 2)
        return silu(out).to(dt)

    mid_geom(y.shape[1], y.shape[2])
    a = conv(y.permute(0, 3, 1, 2), p["w3"], p["b3"], stride=2)
    c12 = conv(a, p["w12"], p["b12"])
    m, c2 = c12[:, :64], c12[:, 64:]
    for w1, b1, w2, b2 in (("wa1", "ba1", "wa2", "ba2"),
                           ("wb1", "bb1", "wb2", "bb2")):
        r = conv(conv(m, p[w1], p[b1]), p[w2], p[b2])
        m = (r.float() + m.float()).to(dt)
    out = conv(torch.cat([m, c2], 1), p["w3o"], p["b3o"])
    return out.permute(0, 2, 3, 1)


def mid_errors(got: Tensor, ref: Tensor) -> Tuple[float, float, float]:
    """(max abs error, max of |error| / (TOL_ABS + TOL_REL * |ref|),
    interior mean abs error) of a K3 output against :func:`mid_plain`; they
    agree when the second is < 1 and the third < TOL_INTERIOR_MEAN."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ratio = err / (TOL_ABS + TOL_REL * ref.abs())
    return (err.max().item(), ratio.max().item(),
            err[:, 2:-2, 2:-2].mean().item())


def bind(lib: ctypes.CDLL):
    """K3's launcher in a library built from ``csrc/yolo_mid.cu`` (or an
    edited copy of it), with its argument types; raises if it reads other
    packed sizes than mid_pack's."""
    fn = lib.lpr_yolo_mid_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    for f in (fn, lib.lpr_yolo_mid_mma_elems, lib.lpr_yolo_mid_bias_elems):
        f.restype = ctypes.c_int
    sizes = (lib.lpr_yolo_mid_mma_elems(), lib.lpr_yolo_mid_bias_elems())
    if sizes != (MMA_ELEMS, BIAS_ELEMS):
        raise RuntimeError(f"csrc/yolo_mid.cu reads {sizes} packed "
                           f"elements, mid_pack packs "
                           f"{(MMA_ELEMS, BIAS_ELEMS)}")
    return fn


@functools.cache
def _launcher():
    from lpr_tpu_torch.kernels._build import library

    return bind(library("yolo_mid"))


def yolo_mid(y: Tensor, packed: Dict[str, Tensor]) -> Tensor:
    """Layers 3-4 of the plate detector on the front output
    (B, H4, W4, 64) -> (B, H4/2, W4/2, 128).

    A CUDA tensor launches the K3 kernel on the current stream (bf16,
    contiguous, H4 and W4 even, a pack whose ``bf16_exact`` is True;
    anything else raises) and adds one to ``yolo_mid.launches``; a CPU
    tensor takes :func:`mid_plain`."""
    refuse_export("yolo_mid")
    if y.device.type == "cpu":
        return mid_plain(y, packed)
    if y.device.type != "cuda":
        raise ValueError(f"yolo_mid runs on cuda or cpu, not {y.device}")
    if y.dtype != torch.bfloat16:
        raise ValueError(f"yolo_mid kernel takes bfloat16, got {y.dtype}")
    if y.dim() != 4 or y.shape[3] != 64:
        raise ValueError(f"expected (B, H4, W4, 64), got {tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError("yolo_mid kernel takes a contiguous NHWC tensor")
    B, H4, W4, _ = y.shape
    h8, w8 = mid_geom(H4, W4)
    if not getattr(packed, "bf16_exact", False):
        raise ValueError("the yolo_mid kernel multiplies bf16 weights: pack "
                         "a bf16 model (mid_pack's bf16_exact is not True)")
    for k, dt, n in (("mma", torch.bfloat16, MMA_ELEMS),
                     ("bias", torch.float32, BIAS_ELEMS)):
        t = packed[k]
        if (t.device != y.device or t.dtype != dt or t.numel() != n
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"packed[{k!r}] must be a contiguous, 16-byte "
                             f"aligned {dt} tensor of {n} elements on "
                             f"{y.device}")
    out = torch.empty((B, h8, w8, 128), dtype=torch.bfloat16, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _launcher()(y.data_ptr(), packed["mma"].data_ptr(),
                          packed["bias"].data_ptr(), out.data_ptr(), B, H4,
                          W4, stream)
    if err != 0:
        raise RuntimeError(f"yolo_mid kernel launch failed: cudaError {err}")
    yolo_mid.launches += 1
    return out


yolo_mid.launches = 0


def mid_work(batch: int, h4: int, w4: int) -> Tuple[int, int]:
    """(floating-point operations, bytes) layers 3-4 need for a batch on a
    (h4, w4) front grid: 2 x multiply-adds of the seven convolutions at
    their output size (h4/2, w4/2); input and output read/written once in
    bf16, plus the packed fp32 weights."""
    h8, w8 = h4 // 2, w4 // 2
    per_pos = (9 * 64 * 128          # L3
               + 128 * 128           # cv1 | cv2
               + 2 * (64 * 64 + 9 * 64 * 64)   # two bottlenecks
               + 128 * 128)          # cv3
    weights = 4 * (9 * 64 * 128 + 128 + 128 * 128 + 128
                   + 2 * (64 * 64 + 64 + 9 * 64 * 64 + 64)
                   + 128 * 128 + 128)
    nbytes = batch * (h4 * w4 * 64 * 2 + h8 * w8 * 128 * 2) + weights
    return 2 * per_pos * h8 * w8 * batch, nbytes
