"""K2: the whole LPSR forward as one kernel, the port of
``lpr_tpu/ops/pallas/lpsr_kernel.py`` ``lpsr_pallas``.

- :func:`lpsr_pack` — gathers an :class:`~lpr_tpu_torch.models.lpsr.LPSR`
  module's weights into one packed float32 buffer plus an offset table,
  with each RDB's residual scale ``alpha`` folded into its ``lff`` weight
  and bias (as ``lpsr_pallas`` folds it), and the 23 wide stages' weights
  once more as bf16 tiles in the tensor cores' B-operand layout (the
  folded ``lff`` as an exact bf16 pair hi + lo) and, for a float32 model,
  as TF32 tiles: each weight split into ``big + small``
  (:func:`tf32_round`), which the float32 kernel multiplies as 3xTF32.
- :func:`lpsr_fused` — the wrapper.  A CUDA tensor goes to the kernel in
  ``lpr_tpu_torch/csrc/lpsr.cu`` (built with nvcc, loaded with ctypes) or
  raises; only a CPU tensor takes the plain version.
- :func:`lpsr_work`, :func:`lpsr_stage_work` — what the forward computes,
  in all and by kernel stage (:data:`STAGES`; :data:`MMA_STAGES` run on
  the tensor cores, in bf16 or as 3xTF32).
- :func:`lpsr_plain` — the same function in plain PyTorch, reading the same
  packed buffer and rounding where the kernel rounds: every convolution
  sums in float32 over the stored inputs, adds its bias in float32 and
  stores in the activation dtype; residual adds, ReLU and the attention
  products work on stored values; the CA mean and MLP and both sigmoids
  are float32 (``_forward_block``, ``lpsr_kernel.py:131-196``).  In float32
  it is ``LPSR.forward`` up to float32 rounding.

The TPU kernel's k-major (un)shuffle channel order, its weight permutation
and its image blocks are TPU layout, not part of the function: the kernel
indexes PyTorch's own order, unshuffled channel ``c*4 + i*2 + j``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# How close the kernel must come to lpsr_plain.  Both round at the same
# points, so they differ only where float32 sums taken in another order
# round to neighbouring values of the activation dtype, and such a one-ulp
# flip travels through the ~35 later layers.  The output is a sigmoid in
# (0, 1).  In bf16: the JAX kernel test holds a bf16 computation to 2e-2 of
# the float32 reference (tests/test_pallas_kernel.py); two bf16
# computations that each meet it are within 4e-2 of each other (measured on
# an H100 at (24, 32, 192, 3), real weights: max 2.03e-2, mean 4.1e-4).  In
# float32: 1e-4.
TOL_MAX = {torch.bfloat16: 4e-2, torch.float32: 1e-4}
TOL_MEAN = {torch.bfloat16: 1e-3, torch.float32: 1e-5}

# The packed entries, in the kernel's order (csrc/lpsr.cu enum W_*).
# Convolution weights are HWIO (kh, kw, cin, cout), depthwise ones
# (kh, kw, c), dense layers (in, out).
_AE = ("conv_in.w",
       "enc0.dw.w", "enc0.dw.b", "enc0.pw.w", "enc0.pw.b",
       "enc1.dw.w", "enc1.dw.b", "enc1.pw.w", "enc1.pw.b",
       "dec0.dw.w", "dec0.dw.b", "dec0.pw.w", "dec0.pw.b",
       "dec1.dw.w", "dec1.dw.b", "dec1.pw.w", "dec1.pw.b",
       "conv_out.w")
_CSAR = ("in0.w", "in0.b", "in1.w", "in1.b", "fc1.w", "fc1.b", "fc2.w",
         "fc2.b", "sa1.w", "sa1.b", "sa2.w", "sa2.b", "out.w", "out.b")
PACK_KEYS: Tuple[str, ...] = (
    tuple(f"ae.{k}" for k in _AE)
    + ("sf1.w", "sf1.b", "sf2.w", "sf2.b")
    + tuple(f"rdb{r}.{k}" for r in range(2)
            for k in ([f"l{i}.{p}" for i in range(4) for p in "wb"]
                      + ["lff.w", "lff.b"]))
    + tuple(f"csar.{k}" for k in _CSAR)
    + ("gff0.w", "gff0.b", "gff1.w", "gff1.b", "final.w", "final.b"))


# The wide stages' bf16 B tiles, in the kernel's order (csrc/lpsr.cu enum
# M_*); each names the PACK_KEYS weight "<key>.w" it holds.
MMA_KEYS: Tuple[str, ...] = (
    ("sf2",)
    + tuple(f"rdb{r}.{k}" for r in range(2)
            for k in ("l0", "l1", "l2", "l3", "lff"))
    + tuple(f"csar.{k}" for k in ("in0", "in1", "sa1", "sa2", "out"))
    + ("gff0", "gff1"))

# K2's 35 stages in launch order (one cluster barrier after each), and the
# 23 that the kernel runs on the tensor cores (bf16, or 3xTF32 in float32).
STAGES: Tuple[str, ...] = tuple(
    ["conv_in", "enc0.dw", "enc0.pw", "enc1.dw", "enc1.pw", "dec0.dw",
     "dec0.pw", "dec1.dw", "dec1.pw", "conv_out", "sf1", "sf2"]
    + [f"rdb0.{k}" for k in ("d0", "d1", "d2", "d3", "lff")]
    + [f"csar0.{k}" for k in ("in0", "in1", "sa1", "sa2", "ca+out")]
    + [f"rdb1.{k}" for k in ("d0", "d1", "d2", "d3", "lff")]
    + [f"csar1.{k}" for k in ("in0", "in1", "sa1", "sa2", "ca+out")]
    + ["gff0", "gff1", "final"])
MMA_STAGES = frozenset(
    ["sf2", "gff0", "gff1"]
    + [f"rdb{r}.{k}" for r in range(2)
       for k in ("d0", "d1", "d2", "d3", "lff")]
    + [f"csar{r}.{k}" for r in range(2)
       for k in ("in0", "in1", "sa1", "sa2", "ca+out")])


class LpsrPacked:
    """One float32 buffer holding every LPSR weight, and the offset (in
    floats, a multiple of 4) and shape of each entry of
    :data:`PACK_KEYS`; the bf16 B tiles of the wide stages (``mma``) and
    their offsets (in elements, a multiple of 8) in :data:`MMA_KEYS` order;
    each RDB's folded ``lff`` weight as its bf16 pair (``lff_hi[r]``,
    ``lff_lo[r]``, (96, 32)); ``bf16_exact``: whether those tiles hold
    the float32 weights exactly (every other wide weight representable in
    bf16, hi + lo == lff bit for bit), which the bf16 kernel needs; and,
    for a float32 model, the TF32 B tiles that the float32 kernel reads
    (``tf32``, float32, each weight as ``big`` and ``small``) and their
    offsets in :data:`MMA_KEYS` order (else None and ())."""

    def __init__(self, buf: Tensor, entries: Dict[str, Tuple[int, tuple]],
                 mma: Tensor, mma_offsets: Tuple[int, ...],
                 lff_hi: Tuple[Tensor, ...], lff_lo: Tuple[Tensor, ...],
                 bf16_exact: bool, tf32: Optional[Tensor] = None,
                 tf32_offsets: Tuple[int, ...] = ()):
        self.buf = buf
        self.entries = entries
        self.offsets = tuple(entries[k][0] for k in PACK_KEYS)
        self.mma = mma
        self.mma_offsets = mma_offsets
        self.lff_hi = lff_hi
        self.lff_lo = lff_lo
        self.bf16_exact = bf16_exact
        self.tf32 = tf32
        self.tf32_offsets = tf32_offsets

    def __getitem__(self, key: str) -> Tensor:
        off, shape = self.entries[key]
        return self.buf[off:off + math.prod(shape)].view(shape)

    def tiles(self, dtype: torch.dtype) -> Tuple[Tensor, Tuple[int, ...]]:
        """The wide stages' B tiles and offsets that the kernel instance of
        ``dtype`` reads: ``mma`` for bfloat16, ``tf32`` for float32
        (ValueError if this pack has none: pack a float32 model)."""
        if dtype == torch.bfloat16:
            return self.mma, self.mma_offsets
        if self.tf32 is None:
            raise ValueError("the float32 kernel runs its wide stages on "
                             "TF32 tiles, which only a float32 model's pack "
                             "holds: pack the model in float32")
        return self.tf32, self.tf32_offsets


def tf32_round(x: Tensor) -> Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, round to nearest,
    ties away from zero: ``cvt.rna.tf32.f32``), as float32 with the 13 low
    mantissa bits zero.  For finite values."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def lpsr_kernel_takes(cfg) -> bool:
    """Whether the kernel takes an
    :class:`~lpr_tpu_torch.models.lpsr.LPSRConfig`: only the production
    configuration (3 -> 1 channels, 32 features, growth 16, 4 blocks of 4
    layers, expansion 4, 5x5 autoencoder kernels)."""
    return (cfg.num_channels, cfg.num_features, cfg.growth_rate,
            cfg.num_blocks, cfg.num_layers, cfg.out_channels, cfg.expansion,
            cfg.ae_kernel) == (3, 32, 16, 4, 4, 1, 4, 5)


def lpsr_pack(model) -> LpsrPacked:
    """Pack a :class:`~lpr_tpu_torch.models.lpsr.LPSR` whose configuration
    the kernel takes (:func:`lpsr_kernel_takes`) into an
    :class:`LpsrPacked` on the model's device, holding the model's own
    values (a bf16 model packs bf16-representable weights; only a float32
    model gets the TF32 tiles); ``alpha`` is folded into each RDB's
    ``lff``.  Raises ValueError on another configuration."""
    cfg = model.cfg
    if not lpsr_kernel_takes(cfg):
        raise ValueError(f"the LPSR kernel takes the production "
                         f"configuration, not {cfg}")

    def hwio(conv):
        return conv.w.float().permute(2, 3, 1, 0)

    def dw(conv):                                   # (C, 1, k, k) -> (k, k, C)
        return conv.w.float()[:, 0].permute(1, 2, 0)

    def mat(conv):                                  # 1x1 -> (cin, cout)
        return hwio(conv)[0, 0]

    def b(conv):
        return conv.b.float()

    ae = model.auto_encoder
    t: List[Tuple[str, Tensor]] = [("ae.conv_in.w", hwio(ae.conv_in))]
    for name in ("enc0", "enc1", "dec0", "dec1"):
        blk = getattr(ae, name)
        t += [(f"ae.{name}.dw.w", dw(blk.dw)), (f"ae.{name}.dw.b", b(blk.dw)),
              (f"ae.{name}.pw.w", mat(blk.pw)), (f"ae.{name}.pw.b", b(blk.pw))]
    t.append(("ae.conv_out.w", hwio(ae.conv_out)))
    t += [("sf1.w", hwio(model.shallowF1)), ("sf1.b", b(model.shallowF1)),
          ("sf2.w", hwio(model.shallowF2)), ("sf2.b", b(model.shallowF2))]
    for r, rdb in enumerate(model.rdbs):
        for i, conv in enumerate(rdb.layers):
            t += [(f"rdb{r}.l{i}.w", hwio(conv)), (f"rdb{r}.l{i}.b", b(conv))]
        alpha = rdb.alpha.float()
        t += [(f"rdb{r}.lff.w", mat(rdb.lff) * alpha),
              (f"rdb{r}.lff.b", b(rdb.lff) * alpha)]
    c = model.csar
    t += [("csar.in0.w", hwio(c.conv_in0)), ("csar.in0.b", b(c.conv_in0)),
          ("csar.in1.w", hwio(c.conv_in1)), ("csar.in1.b", b(c.conv_in1)),
          ("csar.fc1.w", c.ca_fc1_w.float()), ("csar.fc1.b", c.ca_fc1_b.float()),
          ("csar.fc2.w", c.ca_fc2_w.float()), ("csar.fc2.b", c.ca_fc2_b.float()),
          ("csar.sa1.w", mat(c.sa_conv1)), ("csar.sa1.b", b(c.sa_conv1)),
          ("csar.sa2.w", mat(c.sa_conv2)), ("csar.sa2.b", b(c.sa_conv2)),
          ("csar.out.w", mat(c.conv_out)), ("csar.out.b", b(c.conv_out)),
          ("gff0.w", mat(model.gff0)), ("gff0.b", b(model.gff0)),
          ("gff1.w", hwio(model.gff1)), ("gff1.b", b(model.gff1)),
          ("final.w", hwio(model.final_conv)),
          ("final.b", b(model.final_conv))]
    if tuple(k for k, _ in t) != PACK_KEYS:
        raise AssertionError("packed entries out of order")
    entries, parts, off = {}, [], 0
    for key, v in t:
        n = v.numel()
        entries[key] = (off, tuple(v.shape))
        pad = -n % 4                    # 16-byte aligned entries
        parts += [v.reshape(-1), v.new_zeros(pad)]
        off += n + pad
    w = dict(t)

    # The wide stages' B tiles.  The folded lff needs up to 16 significant
    # bits: hi = bf16(w), lo = bf16(w - hi) is exact where w is the product
    # of two bf16 values, and the kernel sums both products.
    lff_hi = tuple(w[f"rdb{r}.lff.w"].to(torch.bfloat16) for r in range(2))
    lff_lo = tuple((w[f"rdb{r}.lff.w"] - hi.float()).to(torch.bfloat16)
                   for r, hi in enumerate(lff_hi))
    exact = all(torch.equal(hi.float() + lo.float(), w[f"rdb{r}.lff.w"])
                for r, (hi, lo) in enumerate(zip(lff_hi, lff_lo)))
    tiles, mma_offsets, moff = [], [], 0
    for key in MMA_KEYS:
        if key.endswith(".lff"):
            r = int(key[3])
            ws = [lff_hi[r], lff_lo[r]]
        else:
            v = w[f"{key}.w"]
            ws = [v.to(torch.bfloat16)]
            exact = exact and torch.equal(ws[0].float(), v)
        mma_offsets.append(moff)
        tiles.append(_b_tiles(ws, 16))
        moff += tiles[-1].numel()
    # The float32 kernel's TF32 tiles: every wide weight (the folded lff
    # too) as big = tf32(w) and small = tf32(w - big), 8 channels a chunk.
    tf32, tf32_offsets = None, ()
    if model.shallowF2.w.dtype == torch.float32:
        t32, offs, o = [], [], 0
        for key in MMA_KEYS:
            v = w[f"{key}.w"]
            big = tf32_round(v)
            offs.append(o)
            t32.append(_b_tiles([big, tf32_round(v - big)], 8))
            o += t32[-1].numel()
        tf32, tf32_offsets = torch.cat(t32).contiguous(), tuple(offs)
    return LpsrPacked(torch.cat(parts).contiguous(), entries,
                      torch.cat(tiles).contiguous(), tuple(mma_offsets),
                      lff_hi, lff_lo, bool(exact), tf32, tf32_offsets)


def _b_tiles(parts: List[Tensor], chunk: int) -> Tensor:
    """One wide stage's weights (each part HWIO (k, k, cin, cout) or
    (cin, cout): one bf16 part, an exact bf16 pair hi, lo, or a TF32 pair
    big, small) as the kernel stages them, flat: per ``chunk``-channel
    input chunk (16 bf16 or 8 float32 channels: 32 bytes), per part, per
    tap, per output channel n one 32-byte row of its input channels, whose
    two 16-byte halves are swapped where bit 2 of n is set (the XOR swizzle
    of csrc/mma_conv.cuh)."""
    w = torch.stack([v.reshape(-1, *v.shape[-2:]) for v in parts])
    n_parts, taps, cin, cout = w.shape
    w = w.reshape(n_parts, taps, cin // chunk, 2, chunk // 2, cout)
    w = w.permute(2, 0, 1, 5, 3, 4)          # chunk, part, tap, n, half, 8
    swap = ((torch.arange(cout, device=w.device) >> 2) & 1).bool()
    w = torch.where(swap[:, None, None], w.flip(4), w)
    return w.reshape(-1)


def _conv(z: Tensor, w: Tensor, b=None, groups: int = 1) -> Tensor:
    """NCHW activations (stored dtype) x HWIO float32 weight -> float32 sum
    plus bias, 'same' padding."""
    if w.dim() == 2:                                # (cin, cout) 1x1
        w = w[None, None]
    if groups > 1:                                  # (k, k, C) depthwise
        w = w[:, :, None, :]
    k = w.shape[0]
    return F.conv2d(z.float(), w.permute(3, 2, 0, 1), b, padding=k // 2,
                    groups=groups)


def lpsr_plain(x: Tensor, p: LpsrPacked) -> Tensor:
    """The plain PyTorch version: x (N, H, W, 3) in [0, 1] -> (N, H, W, 1)
    float32, activations stored in ``x``'s dtype (see the module
    docstring for where it rounds)."""
    dt = x.dtype

    def conv(z, key, bias=True, relu=False):
        y = _conv(z, p[f"{key}.w"], p[f"{key}.b"] if bias else None).to(dt)
        return torch.relu(y) if relu else y

    def dconv(z, key):
        c = z.shape[1]
        y = _conv(z, p[f"{key}.dw.w"], p[f"{key}.dw.b"], groups=c).to(dt)
        return conv(y, f"{key}.pw")

    def add(a, b):
        return (a.float() + b.float()).to(dt)

    z = x.permute(0, 3, 1, 2)
    _, _, h, w = z.shape
    if h % 4 or w % 4:
        raise ValueError(f"LPSR needs H % 4 == 0 and W % 4 == 0, got {(h, w)}")
    ci = conv(z, "ae.conv_in", bias=False)
    y = torch.relu(F.pixel_unshuffle(dconv(ci, "ae.enc0"), 2))
    y = torch.relu(F.pixel_unshuffle(dconv(y, "ae.enc1"), 2))
    y = torch.relu(F.pixel_shuffle(dconv(y, "ae.dec0"), 2))
    y = torch.relu(F.pixel_shuffle(dconv(y, "ae.dec1"), 2))
    y = conv(add(ci, y), "ae.conv_out", bias=False)

    sfe1 = conv(y, "sf1")
    z = conv(sfe1, "sf2")

    def rdb(r, z):
        y = z
        for i in range(4):
            y = torch.cat([y, conv(y, f"rdb{r}.l{i}", relu=True)], 1)
        return add(z, conv(y, f"rdb{r}.lff"))

    def csar(z):
        x_in = conv(conv(z, "csar.in0", relu=True), "csar.in1")
        ca = x_in.float().mean((2, 3))
        ca = torch.relu(ca @ p["csar.fc1.w"] + p["csar.fc1.b"])
        ca = torch.sigmoid(ca @ p["csar.fc2.w"] + p["csar.fc2.b"])
        x_ca = (x_in.float() * ca[:, :, None, None]).to(dt)
        sa = conv(conv(x_in, "csar.sa1", relu=True), "csar.sa2")
        sa = torch.sigmoid(sa.float()).to(dt)
        y = torch.cat([(x_in.float() * x_ca.float()).to(dt),
                       (x_in.float() * sa.float()).to(dt)], 1)
        return add(z, conv(y, "csar.out"))

    feats = []
    for i in range(4):
        z = rdb(i // 2, z) if i % 2 == 0 else csar(z)
        feats.append(z)
    z = add(conv(conv(torch.cat(feats, 1), "gff0"), "gff1"), sfe1)
    out = torch.sigmoid(conv(z, "final").float())
    return out.permute(0, 2, 3, 1).contiguous()


def lpsr_errors(got: Tensor, ref: Tensor) -> Tuple[float, float]:
    """(max abs error, mean abs error) of a K2 output against
    :func:`lpsr_plain`; they agree when both are below TOL_MAX / TOL_MEAN of
    the activation dtype."""
    err = (got.float() - ref.float()).abs()
    return err.max().item(), err.mean().item()


# lpr_lpsr_bf16 / lpr_lpsr_f32: x, wbuf, offsets, n_offsets, wmma (the
# instance's B tiles: bf16 or TF32), mma_offsets, n_mma, scratch, out, n,
# h, w, stream.
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 2
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                      ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])


@functools.cache
def _lib():
    from lpr_tpu_torch.kernels._build import library

    lib = library("lpsr")
    for name in ("lpr_lpsr_bf16", "lpr_lpsr_f32"):
        fn = getattr(lib, name)
        fn.argtypes = LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
    lib.lpr_lpsr_scratch_elems.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lpr_lpsr_scratch_elems.restype = ctypes.c_longlong
    return lib


def lpsr_fused(x: Tensor, packed: LpsrPacked) -> Tensor:
    """The LPSR forward on plate crops x (N, H, W, 3) -> (N, H, W, 1)
    float32.

    A CUDA tensor launches the K2 kernel on the current stream (bfloat16
    or float32 activations, contiguous, H % 4 == 0, W % 4 == 0; bfloat16
    only with a pack whose ``bf16_exact`` holds, since its wide stages run
    on the bf16 tiles, float32 only with a float32 model's pack, whose TF32
    tiles its wide stages read; anything else raises) and adds one to
    ``lpsr_fused.launches``; a CPU tensor takes :func:`lpsr_plain`."""
    if x.device.type == "cpu":
        return lpsr_plain(x, packed)
    if x.device.type != "cuda":
        raise ValueError(f"lpsr_fused runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"lpsr_fused takes bfloat16 or float32, got "
                         f"{x.dtype}")
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"expected (N, H, W, 3), got {tuple(x.shape)}")
    n, h, w, _ = x.shape
    if h % 4 or w % 4 or n <= 0 or h <= 0 or w <= 0:
        raise ValueError(f"LPSR kernel needs H % 4 == 0 and W % 4 == 0, "
                         f"got {(h, w)}")
    if not x.is_contiguous():
        raise ValueError("lpsr_fused takes a contiguous NHWC tensor")
    buf = packed.buf
    if (buf.device != x.device or buf.dtype != torch.float32
            or not buf.is_contiguous() or buf.data_ptr() % 16):
        raise ValueError(f"packed weights must be a contiguous, 16-byte "
                         f"aligned float32 buffer on {x.device}")
    if x.dtype == torch.bfloat16 and not packed.bf16_exact:
        raise ValueError("the bf16 kernel runs its wide stages on bf16 "
                         "weights, and this pack's are not exact in bf16: "
                         "pack a bf16 model (model.to(torch.bfloat16))")
    tiles, tile_offsets = packed.tiles(x.dtype)
    want = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    if (tiles.device != x.device or tiles.dtype != want
            or not tiles.is_contiguous() or tiles.data_ptr() % 16):
        raise ValueError(f"packed B tiles must be a contiguous, 16-byte "
                         f"aligned {want} buffer on {x.device}")
    lib = _lib()
    per_image = lib.lpr_lpsr_scratch_elems(h, w)
    if per_image <= 0:
        raise ValueError(f"LPSR kernel cannot take {(h, w)}")
    scratch = torch.empty(n * per_image, dtype=x.dtype, device=x.device)
    out = torch.empty((n, h, w, 1), dtype=torch.float32, device=x.device)
    offs = (ctypes.c_int * len(packed.offsets))(*packed.offsets)
    moffs = (ctypes.c_int * len(tile_offsets))(*tile_offsets)
    fn = lib.lpr_lpsr_bf16 if x.dtype == torch.bfloat16 else lib.lpr_lpsr_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), buf.data_ptr(), offs, len(offs),
                 tiles.data_ptr(), moffs, len(moffs), scratch.data_ptr(),
                 out.data_ptr(), n, h, w, stream)
    if err != 0:
        raise RuntimeError(f"lpsr kernel launch failed: cudaError {err}")
    lpsr_fused.launches += 1
    return out


lpsr_fused.launches = 0


def lpsr_work(n: int, h: int, w: int, in_bytes: int = 2) -> Tuple[int, int]:
    """(floating-point operations, bytes) of the LPSR forward on n images
    of h x w: 2 x multiply-adds of every convolution and dense layer at its
    own resolution; input read once (``in_bytes`` a value: 2 for bf16, 4
    for float32), float32 output written once, float32 weights read
    once."""
    p, p2, p4 = h * w, (h // 2) * (w // 2), (h // 4) * (w // 4)
    ae = (p * 9 * 3 * 12                            # conv_in
          + p * (25 * 12 + 12 * 12)                 # enc0 dw + pw
          + p2 * (25 * 48 + 48 * 12)                # enc1
          + p4 * (25 * 48 + 48 * 48)                # dec0
          + p2 * (25 * 12 + 12 * 48)                # dec1
          + p * 9 * 12 * 3)                         # conv_out
    rdb = p * (9 * 16 * (32 + 48 + 64 + 80) + 96 * 32)
    csar = p * (2 * 9 * 32 * 32 + 32 * 64 + 64 * 32 + 64 * 32) \
        + 32 * 8 + 8 * 32
    rdn = (p * (49 * 3 * 32 + 9 * 32 * 32)          # shallowF1, F2
           + 2 * rdb + 2 * csar
           + p * (128 * 32 + 9 * 32 * 32 + 9 * 32))  # gff0, gff1, final
    n_weights = (9 * 3 * 12 + 2 * (25 * 12 + 12) + 12 * 12 + 12
                 + 25 * 48 + 48 + 48 * 12 + 12 + 25 * 48 + 48 + 48 * 48 + 48
                 + 12 * 48 + 48 + 9 * 12 * 3
                 + 49 * 3 * 32 + 32 + 9 * 32 * 32 + 32
                 + 2 * (9 * 16 * (32 + 48 + 64 + 80) + 4 * 16 + 96 * 32 + 32)
                 + 2 * (9 * 32 * 32 + 32) + 32 * 8 + 8 + 8 * 32 + 32
                 + 32 * 64 + 64 + 2 * (64 * 32 + 32)
                 + 128 * 32 + 32 + 9 * 32 * 32 + 32 + 9 * 32 + 1)
    nbytes = n * p * (3 * in_bytes + 4) + 4 * n_weights
    return 2 * n * (ae + rdn), nbytes


def lpsr_stage_work(n: int, h: int, w: int) -> Dict[str, int]:
    """Multiply-adds of each of K2's :data:`STAGES` (in that order) on n
    images of h x w, each convolution at its own resolution; the CSAR's
    channel-attention layers count with its conv_out (stage "ca+out").
    Twice their sum is :func:`lpsr_work`'s operations."""
    p, p2, p4 = h * w, (h // 2) * (w // 2), (h // 4) * (w // 4)
    per = {"conv_in": p * 9 * 3 * 12,
           "enc0.dw": p * 25 * 12, "enc0.pw": p * 12 * 12,
           "enc1.dw": p2 * 25 * 48, "enc1.pw": p2 * 48 * 12,
           "dec0.dw": p4 * 25 * 48, "dec0.pw": p4 * 48 * 48,
           "dec1.dw": p2 * 25 * 12, "dec1.pw": p2 * 12 * 48,
           "conv_out": p * 9 * 12 * 3,
           "sf1": p * 49 * 3 * 32, "sf2": p * 9 * 32 * 32}
    for r in range(2):
        per.update({f"rdb{r}.d{i}": p * 9 * (32 + 16 * i) * 16
                    for i in range(4)})
        per[f"rdb{r}.lff"] = p * 96 * 32
        per.update({f"csar{r}.in0": p * 9 * 32 * 32,
                    f"csar{r}.in1": p * 9 * 32 * 32,
                    f"csar{r}.sa1": p * 32 * 64, f"csar{r}.sa2": p * 64 * 32,
                    f"csar{r}.ca+out": p * 64 * 32 + 32 * 8 + 8 * 32})
    per.update({"gff0": p * 128 * 32, "gff1": p * 9 * 32 * 32,
                "final": p * 9 * 32})
    return {k: n * per[k] for k in STAGES}
