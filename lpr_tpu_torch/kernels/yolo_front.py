"""K1: the plate detector's fused front end (layers 0-2), the port of
``lpr_tpu/ops/pallas/yolo_front.py`` ``front_fused``.

- :func:`front_pack` — the weight packer (counterpart of
  ``front_pack_from_params``): checks the layer pattern and gathers the
  detector's BN-folded weights, the stem in its space-to-depth arrangement
  (:func:`lpr_tpu_torch.ops.nn.s2d_stem_weight`), with cv1 and cv2 joined
  into one 64->64 1x1.
- :func:`yolo_front` — the wrapper.  A CUDA tensor goes to the kernel in
  ``lpr_tpu_torch/csrc/yolo_front.cu`` (built with nvcc, loaded with
  ctypes) or raises; only a CPU tensor takes the plain version.
- :func:`front_plain` — the same function as a chain of ``F.conv2d`` +
  SiLU, reading the same packed weights.  The CPU tests use it, and the
  chip check holds the kernel against it.

The TPU kernel's quarter-grid parity planes, lane padding and blocking are
TPU layout, not part of the function, and are not carried over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from lpr_tpu_torch.ops.nn import silu

Tensor = torch.Tensor

# How close K1 must come to front_plain in bf16.  Both round at the same
# points, so they differ only where fp32 sums taken in another order round
# to neighbouring bf16 values; one bf16 ulp is 2^-8..2^-7 of the value
# (0.031 for outputs in [4, 8), which the real weights produce), so the
# bound is 0.03 absolute plus two ulps relative, elementwise over the whole
# tensor, borders included; and the interior mean error below 0.004 (the
# JAX kernel test's bounds, tests/test_pallas_front.py, plus the ulp term).
TOL_ABS = 0.03
TOL_REL = 2.0 ** -7
TOL_INTERIOR_MEAN = 0.004

# Order of the packed tensors in the C launcher's argument list.
PACK_KEYS = ("w0", "b0", "w1", "b1", "w12", "b12", "wm1", "bm1", "wm2",
             "bm2", "w3", "b3")


def front_geom(h: int, w: int) -> Tuple[int, int]:
    """Output grid (h/4, w/4) of a (h, w) detector input; the kernel tiles
    it in 8x16 blocks, so it takes h % 32 == 0 and w % 64 == 0 and raises
    otherwise (as ``lpr_tpu``'s ``front_geom``)."""
    if h % 32 or w % 64 or h <= 0 or w <= 0:
        raise ValueError(f"fused front needs H % 32 == 0 and W % 64 == 0, "
                         f"got {(h, w)}")
    return h // 4, w // 4


def front_pack(model) -> Dict[str, Tensor]:
    """Packed front weights of a :class:`~lpr_tpu_torch.models.yolo.YoloModel`
    whose layers 0-2 are the yolov5s front (S2D stem Conv 3->32 k6 s2 p2,
    Conv 32->64 k3 s2, C3 64->64 n=1 with shortcut, sequential, layers 0/1
    read by no other layer); raises ValueError otherwise.

    fp32 tensors on the model's device, holding the model's own values (so
    a bf16 model packs bf16-representable weights): HWIO ``w0`` (3,3,12,32),
    ``w1`` (3,3,32,64), ``wm2`` (3,3,32,32); (cin, cout) ``w12`` (64,64)
    with cv1 in output channels 0-31 and cv2 in 32-63, ``wm1`` (32,32),
    ``w3`` (64,64); biases (cout,)."""
    from lpr_tpu_torch.models.yolo import C3, Conv

    ls = model.layers
    l0, l1, l2 = (ls[0], ls[1], ls[2]) if len(ls) >= 3 else (None,) * 3
    ok = (type(l0) is Conv and l0._is_s2d_stem() and l0.c1 == 3
          and l0.c2 == 32 and l0.act == "silu"
          and type(l1) is Conv and l1.k == 3 and l1.s == 2 and l1.c1 == 32
          and l1.c2 == 64 and l1.g == 1 and l1.act == "silu"
          and type(l2) is C3 and l2.n == 1 and l2.shortcut and l2.c1 == 64
          and l2.c2 == 64 and l2.g == 1 and l2.e == 0.5
          and l1.f == -1 and l2.f == -1 and not ({0, 1} & set(model.save)))
    if not ok:
        raise ValueError("layers 0-2 do not match the fused front pattern")

    def hwio(conv):
        return conv.conv.w.float().permute(2, 3, 1, 0)

    def mat(conv):                                  # 1x1 -> (cin, cout)
        return hwio(conv)[0, 0]

    def bias(conv):
        return conv.conv.b.float()

    m = l2.m[0]
    packed = {
        "w0": hwio(l0.cv), "b0": bias(l0.cv),
        "w1": hwio(l1.cv), "b1": bias(l1.cv),
        "w12": torch.cat([mat(l2.cv1), mat(l2.cv2)], 1),
        "b12": torch.cat([bias(l2.cv1), bias(l2.cv2)]),
        "wm1": mat(m.cv1), "bm1": bias(m.cv1),
        "wm2": hwio(m.cv2), "bm2": bias(m.cv2),
        "w3": mat(l2.cv3), "b3": bias(l2.cv3),
    }
    # own allocations: the kernel reads 16-byte vectors from each base
    return {k: v.contiguous().clone() for k, v in packed.items()}


def front_plain(x: Tensor, packed: Dict[str, Tensor]) -> Tensor:
    """The plain PyTorch version: letterboxed frames (B, H, W, 3) ->
    (B, H/4, W/4, 64) in ``x``'s dtype.

    It rounds where the kernel (and the TPU kernel) rounds: each conv, its
    bias and SiLU in float32 over the stored inputs, each layer's output
    stored in ``x``'s dtype, the residual sum rounded once.  For float32
    input that is a plain float32 chain."""
    dt = x.dtype

    def conv(z, w, b, stride=1, padding=0):
        if w.dim() == 2:
            w = w[None, None]
        y = F.conv2d(z.float(), w.permute(3, 2, 0, 1).float(), b.float(),
                     stride=stride, padding=padding)
        return silu(y).to(dt)

    p = packed
    z = F.pixel_unshuffle(x.permute(0, 3, 1, 2), 2)
    s = conv(z, p["w0"], p["b0"], padding=1)
    d = conv(s, p["w1"], p["b1"], stride=2, padding=1)
    a = conv(d, p["w12"], p["b12"])
    a1, a2 = a[:, :32], a[:, 32:]
    c = conv(conv(a1, p["wm1"], p["bm1"]), p["wm2"], p["bm2"], padding=1)
    mid = (c.float() + a1.float()).to(dt)
    out = conv(torch.cat([mid, a2], 1), p["w3"], p["b3"])
    return out.permute(0, 2, 3, 1)


def front_errors(got: Tensor, ref: Tensor) -> Tuple[float, float, float]:
    """(max abs error, max of |error| / (TOL_ABS + TOL_REL * |ref|),
    interior mean abs error) of a K1 output against :func:`front_plain`;
    they agree when the second is < 1 and the third < TOL_INTERIOR_MEAN."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ratio = err / (TOL_ABS + TOL_REL * ref.abs())
    return (err.max().item(), ratio.max().item(),
            err[:, 2:-2, 2:-2].mean().item())


@functools.cache
def _launcher():
    from lpr_tpu_torch.kernels._build import library

    fn = library("yolo_front").lpr_yolo_front_bf16
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def yolo_front(x: Tensor, packed: Dict[str, Tensor]) -> Tensor:
    """Layers 0-2 of the plate detector on letterboxed frames
    (B, H, W, 3) -> (B, H/4, W/4, 64).

    A CUDA tensor launches the K1 kernel on the current stream (bf16,
    contiguous, H % 32 == 0, W % 64 == 0; anything else raises) and adds one
    to ``yolo_front.launches``; a CPU tensor takes :func:`front_plain`."""
    if x.device.type == "cpu":
        return front_plain(x, packed)
    if x.device.type != "cuda":
        raise ValueError(f"yolo_front runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"yolo_front kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"expected (B, H, W, 3), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("yolo_front kernel takes a contiguous NHWC tensor")
    B, H, W, _ = x.shape
    h4, w4 = front_geom(H, W)
    for k in PACK_KEYS:
        t = packed[k]
        if (t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"packed[{k!r}] must be a contiguous, 16-byte "
                             f"aligned float32 tensor on {x.device}")
    out = torch.empty((B, h4, w4, 64), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(x.data_ptr(),
                          *[packed[k].data_ptr() for k in PACK_KEYS],
                          out.data_ptr(), B, H, W, stream)
    if err != 0:
        raise RuntimeError(f"yolo_front kernel launch failed: cudaError {err}")
    yolo_front.launches += 1
    return out


yolo_front.launches = 0


def front_work(batch: int, h: int, w: int) -> Tuple[int, int]:
    """(floating-point operations, bytes) the front end needs for a batch:
    2 x multiply-adds of the six convolutions at their exact output sizes;
    input and output read/written once, plus the packed fp32 weights."""
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    macs = (h2 * w2 * 9 * 12 * 32          # stem
            + h4 * w4 * 9 * 32 * 64        # down
            + h4 * w4 * 64 * 64            # cv1 | cv2
            + h4 * w4 * 32 * 32            # m.cv1
            + h4 * w4 * 9 * 32 * 32        # m.cv2
            + h4 * w4 * 64 * 64)           # cv3
    weights = 4 * (9 * 12 * 32 + 32 + 9 * 32 * 64 + 64 + 64 * 64 + 64
                   + 32 * 32 + 32 + 9 * 32 * 32 + 32 + 64 * 64 + 64)
    nbytes = batch * (h * w * 3 * 2 + h4 * w4 * 64 * 2) + weights
    return 2 * macs * batch, nbytes
