"""K1: the plate detector's fused front end (layers 0-2), the port of
``lpr_tpu/ops/pallas/yolo_front.py`` ``front_fused``.

- :func:`front_pack` — the weight packer (counterpart of
  ``front_pack_from_params``): checks the layer pattern and gathers the
  detector's BN-folded weights, the stem in its space-to-depth arrangement
  (:func:`lpr_tpu_torch.ops.nn.s2d_stem_weight`), with cv1 and cv2 joined
  into one 64->64 1x1; and the kernel's operands, each layer's weight as
  bf16 mma B fragments (:data:`MMA_LAYERS`) and the biases in one buffer.
  With ``input_scale`` (1/255) the stem takes raw uint8 frames, as
  ``pack_front_weights(input_scale=...)`` makes the TPU kernel do.
- :func:`yolo_front` — the wrapper.  A CUDA tensor goes to the kernel in
  ``lpr_tpu_torch/csrc/yolo_front.cu`` (built with nvcc, loaded with
  ctypes; bf16 frames, or uint8 frames through the kernel's uint8
  instance, the TPU kernel's ``is_u8`` mode) or raises; only a CPU tensor
  takes the plain version.
- :func:`front_plain` — the same function as a chain of ``F.conv2d`` +
  SiLU, reading the same packed weights.  The CPU tests use it, and the
  chip check holds the kernel against it.
- :func:`front_stage` / :func:`front_stage_plain` — K1 cut after one of
  its :data:`STAGES` (the port of ``tools/probe_front_stages.py``
  ``make_variant``): the same kernel source, one instance per stage, and
  the plain chain stopped at the same point.  They show where K1's time
  goes (``lpr_tpu_torch/tools/probe_front_stages.py``).

The TPU kernel's lane padding and blocking are TPU layout, not part of the
function, and are not carried over; the kernel keeps the stem tile in
parity planes for its own reasons (``csrc/yolo_front.cu``).
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

# The kernel's GEMM operands, in the order of packed["mma"]: per layer its
# weight key, k-steps (taps x 16-channel input chunks) and output channels.
# Each weight is a K x N matrix, K = 16 * k-steps running over (tap,
# chunk, channel), written as bf16 mma.m16n8k16 B fragments
# (:func:`b_frags`).  The biases follow BIAS_KEYS in packed["bias"].
MMA_LAYERS = (("w0", 9, 32), ("w1", 18, 64), ("w12", 4, 64), ("wm1", 2, 32),
              ("wm2", 18, 32), ("w3", 4, 64))
BIAS_KEYS = ("b0", "b1", "b12", "bm1", "bm2", "b3")
MMA_ELEMS = sum(ks * 16 * n for _, ks, n in MMA_LAYERS)     # 41,472
BIAS_ELEMS = 288
# The stem's 16 kernel channels a tap: kernel channel i*6 + j*3 + c (the
# byte order of frame rows 2y + i, pixels 2x + j, channel c) holds
# space-to-depth channel c*4 + i*2 + j; channels 12-15 are zero.
STEM_CHANNELS = tuple((k % 3) * 4 + (k // 6) * 2 + (k % 6) // 3
                      for k in range(12))

# K1's stage variants, in the order of the kernel's enum Stage: the staged
# space-to-depth input, the stem, the down conv, and all of K1.  Each writes
# K1's output shape (B, H/4, W/4, 64) at output position (y, x):
#   dma   plane p = 2*rho + pi in channels p*16 .. p*16+11: the S2D input at
#         (2y + rho, 2x + pi), channel c*4 + i*2 + j; channels p*16+12..15
#         zero;
#   stem  stem(2y, 2x) in channels 0-31 and stem(2y, 2x+1) in 32-63;
#   down  down(y, x);
#   full  K1's output.
STAGES = ("dma", "stem", "down", "full")


def front_geom(h: int, w: int) -> Tuple[int, int]:
    """Output grid (h/4, w/4) of a (h, w) detector input; the kernel tiles
    it in 8x16 blocks, so it takes h % 32 == 0 and w % 64 == 0 and raises
    otherwise (as ``lpr_tpu``'s ``front_geom``)."""
    if h % 32 or w % 64 or h <= 0 or w <= 0:
        raise ValueError(f"fused front needs H % 32 == 0 and W % 64 == 0, "
                         f"got {(h, w)}")
    return h // 4, w // 4


class FrontPacked(dict):
    """:func:`front_pack`'s tensors by key; ``bf16_exact``: whether the
    model's own weights are bf16 values, so that the bf16 B fragments hold
    the packed weights exactly, which the kernel needs; ``dtype``: the
    model's dtype, in which :func:`front_plain` computes on uint8 frames;
    ``input_scale``: the factor folded into the stem."""

    def __init__(self, tensors: Dict[str, Tensor], bf16_exact: bool,
                 dtype: torch.dtype = torch.float32,
                 input_scale: float = 1.0):
        super().__init__(tensors)
        self.bf16_exact = bf16_exact
        self.dtype = dtype
        self.input_scale = input_scale


def gemm_matrix(key: str, w: Tensor) -> Tensor:
    """The K x N matrix that the kernel multiplies for packed weight
    ``key``: K runs over (tap, 16-channel chunk, channel) of the HWIO (or
    (cin, cout)) weight; the stem's 12 channels a tap are reordered by
    :data:`STEM_CHANNELS` and padded with 4 zero rows."""
    if key == "w0":
        w = F.pad(w[:, :, list(STEM_CHANNELS), :], (0, 0, 0, 4))
    return w.reshape(-1, w.shape[-1])


def b_frags(b: Tensor) -> Tensor:
    """A K x N matrix (K, N multiples of 16) as the kernel reads it, bf16,
    flat: per k-step s, per n-tile pair, per lane l, 16 bytes = (b0, b1) of
    n-tile 2*np then of 2*np + 1, where b0 holds B[16s + 2(l%4) + e][8nt +
    l/4] for e = 0, 1 (low half first) and b1 the same 8 rows down: the
    mma.m16n8k16 B fragment of lane l."""
    ks, n = b.shape[0] // 16, b.shape[1]
    s = torch.arange(ks)[:, None, None, None, None]
    pair = torch.arange(n // 16)[None, :, None, None, None]
    lane = torch.arange(32)[None, None, :, None, None]
    word = torch.arange(4)[None, None, None, :, None]
    e = torch.arange(2)[None, None, None, None, :]
    k = 16 * s + 2 * (lane % 4) + 8 * (word % 2) + e
    col = 8 * (2 * pair + word // 2) + lane // 4
    return b.to(torch.bfloat16)[k.to(b.device), col.to(b.device)].reshape(-1)


def front_pack(model, input_scale: float = 1.0) -> FrontPacked:
    """Packed front weights of a :class:`~lpr_tpu_torch.models.yolo.YoloModel`
    whose layers 0-2 are the yolov5s front (S2D stem Conv 3->32 k6 s2 p2,
    Conv 32->64 k3 s2, C3 64->64 n=1 with shortcut, sequential, layers 0/1
    read by no other layer); raises ValueError otherwise.

    fp32 tensors on the model's device, holding the model's own values (so
    a bf16 model packs bf16-representable weights): HWIO ``w0`` (3,3,12,32),
    ``w1`` (3,3,32,64), ``wm2`` (3,3,32,32); (cin, cout) ``w12`` (64,64)
    with cv1 in output channels 0-31 and cv2 in 32-63, ``wm1`` (32,32),
    ``w3`` (64,64); biases (cout,).  For the kernel: ``mma``, the six
    weights' bf16 B fragments in :data:`MMA_LAYERS` order, and ``bias``, the
    biases in :data:`BIAS_KEYS` order (fp32); ``bf16_exact`` tells whether
    every weight is representable in bf16 (as a bf16 model's are).

    ``input_scale`` (1/255 for raw uint8 frames, the counterpart of
    ``front_pack_from_params(input_scale=...)``) multiplies the stem weight
    ``w0`` in float32, and the product is rounded to the model's dtype and
    stored so: the kernel's bf16 fragments and :func:`front_plain` read the
    same values (the TPU kernel casts ``w0 * input_scale`` to bf16 the same
    way).  ``bf16_exact`` is decided on the model's own weights, before the
    fold, which no bf16 value survives unrounded."""
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
    exact = all(torch.equal(packed[k].to(torch.bfloat16).float(), packed[k])
                for k, _, _ in MMA_LAYERS)
    dtype = l0.cv.conv.w.dtype
    if input_scale != 1.0:
        scale = torch.tensor(input_scale, dtype=torch.float32)
        packed["w0"] = (packed["w0"] * scale).to(dtype).float()
    packed["mma"] = torch.cat([b_frags(gemm_matrix(k, packed[k]))
                               for k, _, _ in MMA_LAYERS])
    packed["bias"] = torch.cat([packed[k] for k in BIAS_KEYS])
    # own allocations: the kernel reads 16-byte vectors from each base
    return FrontPacked({k: v.contiguous().clone() for k, v in packed.items()},
                       bool(exact), dtype, float(input_scale))


def _chain(x: Tensor, packed: Dict[str, Tensor], stop: str) -> Tensor:
    """front_plain's layers in order, stopped after stage ``stop``: the
    space-to-depth input (dma), the stem (stem), the down conv (down) or
    the C3 output (full), NCHW in the compute dtype (:func:`front_plain`).
    uint8 frames are cast to it unscaled: the pack's stem carries the
    1/255."""
    dt = (x.dtype if x.is_floating_point()
          else getattr(packed, "dtype", torch.float32))
    x = x.to(dt)

    def conv(z, w, b, stride=1, padding=0):
        if w.dim() == 2:
            w = w[None, None]
        y = F.conv2d(z.float(), w.permute(3, 2, 0, 1).float(), b.float(),
                     stride=stride, padding=padding)
        return silu(y).to(dt)

    p = packed
    z = F.pixel_unshuffle(x.permute(0, 3, 1, 2), 2)
    if stop == "dma":
        return z
    s = conv(z, p["w0"], p["b0"], padding=1)
    if stop == "stem":
        return s
    d = conv(s, p["w1"], p["b1"], stride=2, padding=1)
    if stop == "down":
        return d
    a = conv(d, p["w12"], p["b12"])
    a1, a2 = a[:, :32], a[:, 32:]
    c = conv(conv(a1, p["wm1"], p["bm1"]), p["wm2"], p["bm2"], padding=1)
    mid = (c.float() + a1.float()).to(dt)
    return conv(torch.cat([mid, a2], 1), p["w3"], p["b3"])


def front_plain(x: Tensor, packed: Dict[str, Tensor]) -> Tensor:
    """The plain PyTorch version: letterboxed frames (B, H, W, 3) ->
    (B, H/4, W/4, 64) in the compute dtype: that of float frames; uint8
    frames (a pack made with ``input_scale=1/255``) are cast to the pack's
    model dtype unscaled, exactly, as the kernel's uint8 instance casts
    them to bf16.

    It rounds where the kernel (and the TPU kernel) rounds: each conv, its
    bias and SiLU in float32 over the stored inputs, each layer's output
    stored in the compute dtype, the residual sum rounded once.  In float32
    that is a plain float32 chain."""
    return _chain(x, packed, "full").permute(0, 2, 3, 1)


def front_stage_plain(x: Tensor, packed: Dict[str, Tensor],
                      stage: str) -> Tensor:
    """The plain version of stage variant ``stage`` (:data:`STAGES`):
    frames (B, H, W, 3) -> (B, H/4, W/4, 64) in ``x``'s dtype, laid out as
    :data:`STAGES` describes, from :func:`front_plain`'s own chain."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    t = _chain(x, packed, stage)
    if stage == "dma":                         # (B, 12, H/2, W/2)
        B, C, h2, w2 = t.shape
        t = t.reshape(B, C, h2 // 2, 2, w2 // 2, 2)      # b k y rho x pi
        t = F.pad(t.permute(0, 2, 4, 3, 5, 1), (0, 4))   # b y x rho pi 16
        return t.reshape(B, h2 // 2, w2 // 2, 64)
    if stage == "stem":                        # (B, 32, H/2, W/2)
        t = torch.cat([t[:, :, 0::2, 0::2], t[:, :, 0::2, 1::2]], 1)
    return t.permute(0, 2, 3, 1)


def front_errors(got: Tensor, ref: Tensor) -> Tuple[float, float, float]:
    """(max abs error, max of |error| / (TOL_ABS + TOL_REL * |ref|),
    interior mean abs error) of a K1 output against :func:`front_plain`;
    they agree when the second is < 1 and the third < TOL_INTERIOR_MEAN."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ratio = err / (TOL_ABS + TOL_REL * ref.abs())
    return (err.max().item(), ratio.max().item(),
            err[:, 2:-2, 2:-2].mean().item())


def bind(lib: ctypes.CDLL):
    """(K1's launcher, the stage variants' launcher, K1's uint8 launcher)
    of a library built from ``csrc/yolo_front.cu`` (or an edited copy of
    it), with their argument types; the last is None for a source older
    than the uint8 instance.  Raises if it reads other packed sizes than
    front_pack's."""
    u8 = (lib.lpr_yolo_front_u8 if hasattr(lib, "lpr_yolo_front_u8")
          else None)
    for fn in (lib.lpr_yolo_front_bf16, u8):
        if fn is not None:
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
    lib.lpr_yolo_front_stage_bf16.argtypes = ([ctypes.c_void_p] * 4
                                              + [ctypes.c_int] * 4
                                              + [ctypes.c_void_p])
    for fn in (lib.lpr_yolo_front_bf16, lib.lpr_yolo_front_stage_bf16, u8,
               lib.lpr_yolo_front_mma_elems, lib.lpr_yolo_front_bias_elems):
        if fn is not None:
            fn.restype = ctypes.c_int
    sizes = (lib.lpr_yolo_front_mma_elems(), lib.lpr_yolo_front_bias_elems())
    if sizes != (MMA_ELEMS, BIAS_ELEMS):
        raise RuntimeError(f"csrc/yolo_front.cu reads {sizes} packed "
                           f"elements, front_pack packs "
                           f"{(MMA_ELEMS, BIAS_ELEMS)}")
    return lib.lpr_yolo_front_bf16, lib.lpr_yolo_front_stage_bf16, u8


@functools.cache
def _launchers():
    from lpr_tpu_torch.kernels._build import library

    return bind(library("yolo_front"))


def _launch(x: Tensor, packed: Dict[str, Tensor], name: str,
            stage=None) -> Tensor:
    """Checks a CUDA launch of K1 (``stage`` None; bf16 or uint8 frames)
    or of a stage variant (bf16), launches it on the current stream and
    returns the output."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    takes = ((torch.bfloat16,) if stage is not None
             else (torch.bfloat16, torch.uint8))
    if x.dtype not in takes:
        raise ValueError(f"{name} kernel takes {takes}, got {x.dtype}")
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"expected (B, H, W, 3), got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} kernel takes a contiguous, 16-byte "
                         f"aligned NHWC tensor")
    B, H, W, _ = x.shape
    h4, w4 = front_geom(H, W)
    if not getattr(packed, "bf16_exact", False):
        raise ValueError(f"the {name} kernel multiplies bf16 weights: pack "
                         f"a bf16 model (front_pack's bf16_exact is not "
                         f"True)")
    for k, dt, n in (("mma", torch.bfloat16, MMA_ELEMS),
                     ("bias", torch.float32, BIAS_ELEMS)):
        t = packed[k]
        if (t.device != x.device or t.dtype != dt or t.numel() != n
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"packed[{k!r}] must be a contiguous, 16-byte "
                             f"aligned {dt} tensor of {n} elements on "
                             f"{x.device}")
    out = torch.empty((B, h4, w4, 64), dtype=torch.bfloat16, device=x.device)
    k1, variant, k1_u8 = _launchers()
    if x.dtype == torch.uint8 and k1_u8 is None:
        raise RuntimeError(f"this {name} library has no uint8 instance")
    args = [x.data_ptr(), packed["mma"].data_ptr(), packed["bias"].data_ptr(),
            out.data_ptr(), B, H, W]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stage is not None:
            err = variant(*args, STAGES.index(stage), stream)
        else:
            err = (k1_u8 if x.dtype == torch.uint8 else k1)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def yolo_front(x: Tensor, packed: Dict[str, Tensor]) -> Tensor:
    """Layers 0-2 of the plate detector on letterboxed frames
    (B, H, W, 3) -> (B, H/4, W/4, 64).

    A CUDA tensor launches the K1 kernel on the current stream (contiguous
    and 16-byte aligned, H % 32 == 0, W % 64 == 0, a pack whose
    ``bf16_exact`` is True; anything else raises): bf16 frames its bf16
    instance, counted in ``yolo_front.launches``; uint8 frames (with a pack
    made at ``input_scale=1/255``) its uint8 instance, counted in
    ``yolo_front.launches_u8``; the output is bf16.  A CPU tensor takes
    :func:`front_plain`."""
    if x.device.type == "cpu":
        return front_plain(x, packed)
    out = _launch(x, packed, "yolo_front")
    if x.dtype == torch.uint8:
        yolo_front.launches_u8 += 1
    else:
        yolo_front.launches += 1
    return out


yolo_front.launches = 0
yolo_front.launches_u8 = 0


def front_stage(x: Tensor, packed: Dict[str, Tensor], stage: str) -> Tensor:
    """K1's stage variant ``stage`` (:data:`STAGES`) on letterboxed frames
    (B, H, W, 3) -> (B, H/4, W/4, 64).

    A CUDA tensor launches that instance of the K1 kernel on the current
    stream (the checks of :func:`yolo_front`) and adds one to
    ``front_stage.launches[stage]``; a CPU tensor takes
    :func:`front_stage_plain`.  ``"full"`` runs K1's own instance."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if x.device.type == "cpu":
        return front_stage_plain(x, packed, stage)
    out = _launch(x, packed, f"front_stage[{stage}]", stage)
    front_stage.launches[stage] += 1
    return out


front_stage.launches = dict.fromkeys(STAGES, 0)


def front_work(batch: int, h: int, w: int,
               in_bytes: int = 2) -> Tuple[int, int]:
    """(floating-point operations, bytes) the front end needs for a batch:
    2 x multiply-adds of the six convolutions at their exact output sizes;
    input (``in_bytes`` a value: 2 for bf16, 1 for uint8 frames) and
    output read/written once, plus the packed fp32 weights."""
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    macs = (h2 * w2 * 9 * 12 * 32          # stem
            + h4 * w4 * 9 * 32 * 64        # down
            + h4 * w4 * 64 * 64            # cv1 | cv2
            + h4 * w4 * 32 * 32            # m.cv1
            + h4 * w4 * 9 * 32 * 32        # m.cv2
            + h4 * w4 * 64 * 64)           # cv3
    weights = 4 * (9 * 12 * 32 + 32 + 9 * 32 * 64 + 64 + 64 * 64 + 64
                   + 32 * 32 + 32 + 9 * 32 * 32 + 32 + 64 * 64 + 64)
    nbytes = batch * (h * w * 3 * in_bytes + h4 * w4 * 64 * 2) + weights
    return 2 * macs * batch, nbytes


def front_stage_work(stage: str, batch: int, h: int,
                     w: int) -> Tuple[int, int]:
    """(floating-point operations, bytes) of stage variant ``stage``: the
    convolutions it runs (2 x multiply-adds at their exact output sizes,
    cumulative: stem, + down, + the C3 = :func:`front_work`); every variant
    reads the input and writes K1's output shape once, plus the fp32
    weights of the layers it runs."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if stage == "full":
        return front_work(batch, h, w)
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    macs, weights = 0, 0
    if stage in ("stem", "down"):
        macs += h2 * w2 * 9 * 12 * 32
        weights += 9 * 12 * 32 + 32
    if stage == "down":
        macs += h4 * w4 * 9 * 32 * 64
        weights += 9 * 32 * 64 + 64
    nbytes = batch * (h * w * 3 * 2 + h4 * w4 * 64 * 2) + 4 * weights
    return 2 * macs * batch, nbytes
