"""YOLOv5-family detectors (counterpart of ``lpr_tpu/models/yolo.py``): the
plate detector (yolov5s, nc=11, 3 scales), the char OCR model
(Focus/SPP/C3TR, stride 8) and the rest of the JAX package's zoo.

The same spec grammar and builder (rows of ``[from, number, module, args]``
with depth/width multiples) produce a :class:`YoloModel` of
``torch.nn.Module`` layers, for every module name of the JAX builder
(Conv, DWConv, Focus, Bottleneck, BottleneckCSP, C3, C3TR, C3SPP, C3Ghost,
GhostConv, GhostBottleneck, SPP, SPPF, Concat, Contract, Expand,
nn.Upsample, Detect, Classify), and the named sizes yolov5{n,s,m,l,x} with
their P6 variants (:func:`yolov5`).  Weights come from the repo's flat npz
state (:mod:`lpr_tpu_torch.weights.checkpoint`) or from a YOLOv5 ``.pt``,
the reference's pickled ``Model``, read without running pickled code and
mapped onto the same flat state (:func:`load_yolo_torch`,
:func:`state_from_torch`), with batch norm folded into the convolutions at
load time (``fuse_conv_bn``, eps 1e-3): the port runs inference only.
Activations are NHWC throughout; ``Detect`` returns the raw per-scale
logits ``(B, na, ny, nx, 5+nc)`` for lazy-decode NMS, and with
``decode=True`` also the decoded ``(B, N, 5+nc)`` predictions.
:func:`quantize_yolo` gives the detector its int8 form
(``PipelineConfig.int8_detector``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lpr_tpu_torch.device import DeviceLike, resolve_device
from lpr_tpu_torch.kernels import conv_int8 as ki
from lpr_tpu_torch.ops import nn as tnn
from lpr_tpu_torch.weights.checkpoint import State, load_state

Tensor = torch.Tensor


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def _folded(state: State, prefix: str):
    """HWIO weight + bias of the conv at ``prefix``, batch norm folded."""
    w = state[f"{prefix}/w"]
    b = state.get(f"{prefix}/b")
    if f"{prefix}/bn/gamma" in state:
        w, b = tnn.fuse_conv_bn(w, b, state[f"{prefix}/bn/gamma"],
                                state[f"{prefix}/bn/beta"],
                                state[f"{prefix}/bn/mean"],
                                state[f"{prefix}/bn/var"])
    return w, b


class AmaxPlan:
    """The int8 detector's exact per-tensor maxima (:func:`plan_amax`): one
    float32 slot for each tensor whose max|x| a quantize reads, zeroed by
    one memset a forward (``buf``, set by :meth:`YoloModel.forward_from`
    for the length of a forward, None outside it).  An I2 epilogue takes
    its output's max into its slot (``ConvAct.out_slot``); a conv's
    quantize reads the slots of the tensors its input is made of
    (``ConvAct.in_plan``), or, where no slot holds the max, I1's max pass
    fills one first."""

    def __init__(self):
        self.n = 0
        self.start: Optional[int] = None
        self.buf: Optional[Tensor] = None

    def new(self) -> int:
        self.n += 1
        return self.n - 1


class ConvAct(torch.nn.Module):
    """Conv(+folded BN)+activation, the JAX package's ``_conv``.

    :meth:`quantize` adds the int8 form of the weight (``quantize_yolo``'s
    ``w_q``/``w_s``/``b``); from then on the layer runs
    :func:`tnn.conv2d_int8` (``lpr_tpu/models/yolo.py:82-96``) with its
    activation, and a Bottleneck's shortcut (``residual``), in the int8
    kernel's epilogue.  ``forward`` takes a tensor or, for convs that read
    the same tensor, its :class:`~lpr_tpu_torch.kernels.conv_int8
    .QuantizedAct` (:meth:`quantize_input`).  The float weight stays beside
    the int8 one, for the K1 and K3 packs (``int8_detector`` quantizes
    after they are built from the float weights, as the JAX recognizer
    does).  The float32 scale and bias are held as int32 bit views, so
    that casting the model to bf16 leaves them as they are."""

    def __init__(self, state: State, prefix: str, *, k: int, stride: int = 1,
                 pad=None, groups: int = 1, act: str = "silu"):
        super().__init__()
        w, b = _folded(state, prefix)
        self.conv = tnn.Conv2d.from_hwio(
            w, b, stride=stride, padding=k // 2 if pad is None else pad,
            groups=groups)
        self.act = act
        self.prefix = prefix
        self.quantized = False
        # plan_amax's entries: (slots, max pass first) of the input, the
        # output's slot, the plan
        self.in_plan: Optional[Tuple[Tuple[int, ...], bool]] = None
        self.out_slot: Optional[int] = None
        self.plan: Optional[AmaxPlan] = None

    def int8_eligible(self, min_contract: int = 64) -> bool:
        """``quantize_yolo``'s rule on the HWIO weight: Cin/groups > 1 and
        kh * kw * Cin/groups >= ``min_contract``."""
        _, cig, kh, kw = self.conv.w.shape
        return cig > 1 and kh * kw * cig >= min_contract

    def quantize(self) -> None:
        """Quantize the weight the layer holds (float32 as loaded) per
        output channel (:func:`tnn.quantize_conv_weight`) and pack it for
        I2 (on a card its TMA descriptor is encoded here); a second call
        keeps the first codes."""
        if self.quantized:
            return
        dev = self.conv.w.device
        w = self.conv.w.detach().float().permute(2, 3, 1, 0).cpu().numpy()
        wq, ws = tnn.quantize_conv_weight(w)
        self.register_buffer("w_q", torch.from_numpy(wq).to(dev))
        self.register_buffer("w_pack", ki.int8_pack(wq).to(dev))
        if dev.type == "cuda":
            ki.weight_map(self.w_pack, wq.shape[2])
        self.register_buffer("w_s_bits",
                             torch.from_numpy(ws).view(torch.int32).to(dev))
        b = self.conv.b
        self.register_buffer("b_bits", None if b is None else (
            b.detach().float().clone().view(torch.int32)))
        self.quantized = True

    def _slots(self, idx) -> Optional[List[Tensor]]:
        """The plan's slots ``idx`` of this forward, or None outside a
        planned forward."""
        if self.plan is None or self.plan.buf is None:
            return None
        return [self.plan.buf[k:k + 1] for k in idx]

    def quantize_input(self, x: Tensor) -> "ki.QuantizedAct":
        """I1 on this conv's input: its quantize reads the plan's slots
        (after I1's max pass fills one, where no slot holds the max), or,
        outside a planned forward, runs its own max pass."""
        slots = None if self.in_plan is None else self._slots(
            self.in_plan[0])
        if slots is not None and self.in_plan[1]:
            ki.act_amax(x, slots[0])
        xq, sx = ki.quantize_act(x, slots)
        return ki.QuantizedAct(x, xq, sx)

    def forward(self, x, residual: Optional[Tensor] = None) -> Tensor:
        if not self.quantized:
            if isinstance(x, ki.QuantizedAct):
                x = x.x
            y = tnn.act(self.conv(x), self.act)
            return y if residual is None else residual + y
        q = x if isinstance(x, ki.QuantizedAct) else self.quantize_input(x)
        amax = (None if self.out_slot is None
                else self._slots((self.out_slot,)))
        c = self.conv
        return tnn.conv2d_int8(
            q.x, self.w_q, self.w_s_bits.view(torch.float32),
            None if self.b_bits is None else self.b_bits.view(torch.float32),
            stride=c.stride, padding=c.padding, groups=c.groups,
            packed=self.w_pack, xq=(q.xq, q.sx), act=self.act,
            residual=residual, amax=None if amax is None else amax[0])


def _plan_in(conv: ConvAct, d, plan: AmaxPlan) -> None:
    """``conv`` reads a tensor whose max|x| is the max of the slots ``d``
    (None: no slot holds it, so I1's max pass fills a new one)."""
    if conv.quantized:
        conv.in_plan = (d, False) if d is not None else ((plan.new(),), True)
        conv.plan = plan


def _plan_out(conv: ConvAct, plan: AmaxPlan):
    """The slots of ``conv``'s output: its epilogue's own, if it is int8."""
    if not conv.quantized:
        return None
    conv.out_slot = plan.new()
    conv.plan = plan
    return (conv.out_slot,)


def _plan_union(ds):
    """The slots of a concat of tensors of slots ``ds`` (at most the 4 a
    quantize reads; None if a part's max is not known)."""
    if any(d is None for d in ds):
        return None
    slots = tuple(sorted({k for d in ds for k in d}))
    return slots if len(slots) <= 4 else None


class Layer(torch.nn.Module):
    """One node of the layer plan; the builder sets ``i`` and ``f``."""

    i: int = 0
    f: Any = -1

    def load(self, state: State, prefix: str) -> None:
        """Build this layer's tensors from the flat state."""

    def plan_amax(self, d, plan: AmaxPlan):
        """Plan this layer's int8 convs (:func:`plan_amax`) on an input
        whose max|x| is the max of slots ``d`` (None: not known; for a
        layer of several inputs, their list); returns its output's slots.
        By default a layer's convs take I1's max pass, and its output's max
        is not known."""
        for m in self.modules():
            if isinstance(m, ConvAct):
                _plan_in(m, None, plan)
        return None


class Conv(Layer):
    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 pad: Optional[int] = None, g: int = 1, act: str = "silu"):
        super().__init__()
        self.c1, self.c2, self.k, self.s, self.pad, self.g = c1, c2, k, s, pad, g
        self.act = act

    def _is_s2d_stem(self) -> bool:
        """The v6.0 stem Conv(6, s=2, p=2) equals space-to-depth(2) + a 3x3
        conv with rearranged weights (:func:`tnn.s2d_stem_weight`)."""
        return self.k == 6 and self.s == 2 and self.pad == 2 and self.g == 1

    def load(self, state, prefix):
        if self._is_s2d_stem():
            w, b = _folded(state, prefix)
            st = {f"{prefix}/w": tnn.s2d_stem_weight(w), f"{prefix}/b": b}
            self.cv = ConvAct(st, prefix, k=3, stride=1, pad=1, act=self.act)
        else:
            self.cv = ConvAct(state, prefix, k=self.k, stride=self.s,
                              pad=self.pad, groups=self.g, act=self.act)

    def forward(self, x):
        if self._is_s2d_stem():
            x = tnn.pixel_unshuffle(x, 2)
        return self.cv(x)

    def plan_amax(self, d, plan):
        if self._is_s2d_stem():
            return super().plan_amax(d, plan)
        _plan_in(self.cv, d, plan)
        return _plan_out(self.cv, plan)


class DWConv(Conv):
    """Depthwise conv: groups = gcd(c1, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 pad: Optional[int] = None, act: str = "silu"):
        super().__init__(c1, c2, k, s, pad, math.gcd(c1, c2), act)


class Focus(Layer):
    """Space-to-depth 2x2 + Conv."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.c1, self.c2, self.k, self.s = c1, c2, k, s

    def load(self, state, prefix):
        self.cv = ConvAct(state, prefix, k=self.k, stride=self.s)

    def forward(self, x):
        return self.cv(tnn.space_to_depth_focus(x))


class Bottleneck(torch.nn.Module):
    """1x1 -> 3x3 bottleneck with optional residual."""

    def __init__(self, state, prefix, shortcut: bool, g: int = 1):
        super().__init__()
        self.cv1 = ConvAct(state, f"{prefix}/cv1", k=1)
        self.cv2 = ConvAct(state, f"{prefix}/cv2", k=3, groups=g)
        self.shortcut = shortcut

    def forward(self, x):
        return self.cv2(self.cv1(x), residual=x if self.shortcut else None)

    def plan_amax(self, d, plan):
        _plan_in(self.cv1, d, plan)
        _plan_in(self.cv2, _plan_out(self.cv1, plan), plan)
        y = _plan_out(self.cv2, plan)
        # an int8 cv2 adds the shortcut in its epilogue, before the max
        return y if self.cv2.quantized or not self.shortcut else None


class C3(Layer):
    """CSP bottleneck with 3 convs."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        self.c1, self.c2, self.n, self.shortcut, self.g, self.e = (
            c1, c2, n, shortcut, g, e)

    def load(self, state, prefix):
        self.cv1 = ConvAct(state, f"{prefix}/cv1", k=1)
        self.cv2 = ConvAct(state, f"{prefix}/cv2", k=1)
        self.cv3 = ConvAct(state, f"{prefix}/cv3", k=1)
        self.load_inner(state, prefix)

    def load_inner(self, state, prefix):
        self.m = torch.nn.Sequential(*[
            Bottleneck(state, f"{prefix}/m/{j}", self.shortcut, self.g)
            for j in range(self.n)])

    def forward(self, x):
        if self.cv1.quantized and self.cv2.quantized:
            x = self.cv1.quantize_input(x)     # one quantize for both
        y1 = self.m(self.cv1(x))
        return self.cv3(torch.cat([y1, self.cv2(x)], -1))

    def plan_amax(self, d, plan):
        if type(self) is not C3:       # C3TR, C3SPP, C3Ghost: other m
            return super().plan_amax(d, plan)
        _plan_in(self.cv1, d, plan)
        _plan_in(self.cv2, d, plan)
        y = _plan_out(self.cv1, plan)
        for b in self.m:
            y = b.plan_amax(y, plan)
        _plan_in(self.cv3, _plan_union([y, _plan_out(self.cv2, plan)]), plan)
        return _plan_out(self.cv3, plan)


class BottleneckLayer(Layer):
    """The builder's ``Bottleneck`` module: the residual applies only where
    c1 == c2, as in the JAX builder."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1):
        super().__init__()
        self.c1, self.c2, self.shortcut, self.g = c1, c2, shortcut, g

    def load(self, state, prefix):
        self.b = Bottleneck(state, prefix, self.shortcut and self.c1 == self.c2,
                            self.g)

    def forward(self, x):
        return self.b(x)

    def plan_amax(self, d, plan):
        return self.b.plan_amax(d, plan)


class BottleneckCSP(Layer):
    """v4-style CSP bottleneck: bias-free cv2/cv3 without BN, a standalone
    batch norm (eps 1e-5) and SiLU on their concat, then cv4."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        self.c1, self.c2, self.n, self.shortcut, self.g, self.e = (
            c1, c2, n, shortcut, g, e)

    def load(self, state, prefix):
        self.cv1 = ConvAct(state, f"{prefix}/cv1", k=1)
        self.cv2 = ConvAct(state, f"{prefix}/cv2", k=1, pad=0, act="none")
        self.cv3 = ConvAct(state, f"{prefix}/cv3", k=1, pad=0, act="none")
        self.cv4 = ConvAct(state, f"{prefix}/cv4", k=1)
        self.m = torch.nn.Sequential(*[
            Bottleneck(state, f"{prefix}/m/{j}", self.shortcut, self.g)
            for j in range(self.n)])
        bn = {k: np.asarray(state[f"{prefix}/bn/{k}"], np.float32)
              for k in ("gamma", "beta", "mean", "var")}
        scale = bn["gamma"] / np.sqrt(bn["var"] + np.float32(1e-5))
        _buffer(self, "bn_scale", scale)
        _buffer(self, "bn_shift", bn["beta"] - bn["mean"] * scale)

    def forward(self, x):
        y1 = self.cv3(self.m(self.cv1(x)))
        cat = torch.cat([y1, self.cv2(x)], -1)
        cat = cat * self.bn_scale.to(cat.dtype) + self.bn_shift.to(cat.dtype)
        return self.cv4(tnn.silu(cat))


class GhostConv(Layer):
    """Ghost conv: a k x k conv to c2/2 channels, then a 5x5 depthwise
    "cheap" conv of it, concatenated; ``act`` applies to both."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: str = "silu"):
        super().__init__()
        self.c1, self.c2, self.k, self.s, self.act = c1, c2, k, s, act

    def load(self, state, prefix):
        c_ = self.c2 // 2
        self.cv1 = ConvAct(state, f"{prefix}/cv1", k=self.k, stride=self.s,
                           act=self.act)
        self.cv2 = ConvAct(state, f"{prefix}/cv2", k=5, groups=c_,
                           act=self.act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], -1)


class GhostBottleneck(Layer):
    """Ghost bottleneck: GhostConv (SiLU), a k x k depthwise stride-2 conv
    when s == 2, GhostConv without activation (the reference's pw-linear
    ``act=False``), plus the identity or, at s == 2, a depthwise + 1x1
    shortcut, both linear."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        self.c1, self.c2, self.k, self.s = c1, c2, k, s

    def load(self, state, prefix):
        c_ = self.c2 // 2
        self.g1 = GhostConv(self.c1, c_, 1, 1)
        self.g1.load(state, f"{prefix}/g1")
        self.g2 = GhostConv(c_, self.c2, 1, 1, act="none")
        self.g2.load(state, f"{prefix}/g2")
        if self.s == 2:
            self.dw = ConvAct(state, f"{prefix}/dw", k=self.k, stride=2,
                              groups=c_, act="none")
            self.sc_dw = ConvAct(state, f"{prefix}/sc_dw", k=self.k,
                                 stride=2, groups=self.c1, act="none")
            self.sc_pw = ConvAct(state, f"{prefix}/sc_pw", k=1, act="none")

    def forward(self, x):
        y = self.g1(x)
        if self.s == 2:
            y = self.dw(y)
        y = self.g2(y)
        sc = self.sc_pw(self.sc_dw(x)) if self.s == 2 else x
        return y + sc


class SPP(Layer):
    """Spatial pyramid pooling."""

    def __init__(self, c1: int, c2: int, k: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        self.c1, self.c2, self.k = c1, c2, tuple(k)

    def load(self, state, prefix):
        self.cv1 = ConvAct(state, f"{prefix}/cv1", k=1)
        self.cv2 = ConvAct(state, f"{prefix}/cv2", k=1)

    def forward(self, x):
        y = self.cv1(x)
        pools = [tnn.max_pool2d(y, kk, 1, kk // 2) for kk in self.k]
        return self.cv2(torch.cat([y] + pools, -1))


class SPPF(Layer):
    """Fast SPP: three chained k-pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        self.c1, self.c2, self.k = c1, c2, k

    def load(self, state, prefix):
        self.cv1 = ConvAct(state, f"{prefix}/cv1", k=1)
        self.cv2 = ConvAct(state, f"{prefix}/cv2", k=1)

    def forward(self, x):
        y = self.cv1(x)
        y1 = tnn.max_pool2d(y, self.k, 1, self.k // 2)
        y2 = tnn.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = tnn.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([y, y1, y2, y3], -1))

    def plan_amax(self, d, plan):
        # every max-pool output is an element of y (the window covers its
        # centre, and the -inf padding never wins): the concat's max is y's
        _plan_in(self.cv1, d, plan)
        _plan_in(self.cv2, _plan_out(self.cv1, plan), plan)
        return _plan_out(self.cv2, plan)


def _buffer(module: torch.nn.Module, name: str, arr: np.ndarray) -> None:
    module.register_buffer(name, torch.from_numpy(
        np.ascontiguousarray(arr, np.float32)))


class TransformerBlockL(torch.nn.Module):
    """ViT block on a conv feature map, LayerNorm-free: tokens are the
    flattened H*W positions; a learnable positional Linear; per layer q/k/v
    Linears (no bias) into torch-style multi-head attention, then two
    bias-free FC residuals.  Linear weights are (in, out)."""

    _KEYS = ("q", "k", "v", "in_proj_w", "in_proj_b", "out_proj_w",
             "out_proj_b", "fc1", "fc2")

    def __init__(self, state, prefix, c: int, num_heads: int,
                 num_layers: int):
        super().__init__()
        self.c, self.num_heads, self.num_layers = c, num_heads, num_layers
        self.conv = (ConvAct(state, f"{prefix}/conv", k=1)
                     if f"{prefix}/conv/w" in state else None)
        _buffer(self, "lin_w", state[f"{prefix}/linear/w"])
        _buffer(self, "lin_b", state[f"{prefix}/linear/b"])
        for j in range(num_layers):
            for key in self._KEYS:
                _buffer(self, f"tr{j}_{key}", state[f"{prefix}/tr/{j}/{key}"])

    def _mha(self, j: int, q, k, v):
        c, h = self.c, self.num_heads
        dk = c // h
        w = getattr(self, f"tr{j}_in_proj_w")
        b = getattr(self, f"tr{j}_in_proj_b")
        q2 = tnn.linear(q, w[:, :c], b[:c])
        k2 = tnn.linear(k, w[:, c:2 * c], b[c:2 * c])
        v2 = tnn.linear(v, w[:, 2 * c:], b[2 * c:])
        B, L, _ = q2.shape
        q2 = q2.reshape(B, L, h, dk).transpose(1, 2) / math.sqrt(dk)
        k2 = k2.reshape(B, L, h, dk).transpose(1, 2)
        v2 = v2.reshape(B, L, h, dk).transpose(1, 2)
        att = torch.softmax(q2 @ k2.transpose(-1, -2), dim=-1)
        out = (att @ v2).transpose(1, 2).reshape(B, L, c)
        return tnn.linear(out, getattr(self, f"tr{j}_out_proj_w"),
                          getattr(self, f"tr{j}_out_proj_b"))

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        B, H, W, C = x.shape
        t = x.reshape(B, H * W, C)
        t = t + tnn.linear(t, self.lin_w, self.lin_b)
        for j in range(self.num_layers):
            p = {k: getattr(self, f"tr{j}_{k}") for k in ("q", "k", "v",
                                                           "fc1", "fc2")}
            t = self._mha(j, tnn.linear(t, p["q"]), tnn.linear(t, p["k"]),
                          tnn.linear(t, p["v"])) + t
            t = tnn.linear(tnn.linear(t, p["fc1"]), p["fc2"]) + t
        return t.reshape(B, H, W, C)


class C3TR(C3):
    """C3 with a TransformerBlock inner."""

    def load_inner(self, state, prefix):
        c_ = int(self.c2 * self.e)
        self.m = TransformerBlockL(state, f"{prefix}/m", c_, 4, self.n)


class C3SPP(C3):
    """C3 with an SPP inner."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, k: Tuple[int, ...] = (5, 9, 13)):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.k = tuple(k)

    def load_inner(self, state, prefix):
        c_ = int(self.c2 * self.e)
        self.m = SPP(c_, c_, self.k)
        self.m.load(state, f"{prefix}/m")


class C3Ghost(C3):
    """C3 with GhostBottleneck inners."""

    def load_inner(self, state, prefix):
        c_ = int(self.c2 * self.e)
        blocks = []
        for j in range(self.n):
            gb = GhostBottleneck(c_, c_)
            gb.load(state, f"{prefix}/m/{j}")
            blocks.append(gb)
        self.m = torch.nn.Sequential(*blocks)


class Classify(Layer):
    """Classification head: global average pool (of each input, then
    concatenated, for a list), a 1x1 conv with bias, flattened."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.c1, self.c2, self.k, self.s = c1, c2, k, s

    def load(self, state, prefix):
        self.cv = ConvAct(state, prefix, k=self.k, stride=self.s, pad=0,
                          act="none")

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat([tnn.global_avg_pool(xi) for xi in x], -1)
        else:
            x = tnn.global_avg_pool(x)
        y = self.cv(x[:, None, None, :])
        return y.reshape(y.shape[0], -1)


class Contract(Layer):
    """W x H -> channels (space-to-depth by ``gain``)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        return tnn.pixel_unshuffle(x, self.gain)


class Expand(Layer):
    """Channels -> W x H (depth-to-space by ``gain``)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        return tnn.pixel_shuffle(x, self.gain)


class Upsample(Layer):
    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return tnn.upsample_nearest(x, self.scale)

    def plan_amax(self, d, plan):
        return d


class Concat(Layer):
    def forward(self, xs):
        return torch.cat(xs, -1)

    def plan_amax(self, d, plan):
        return _plan_union(d)


class Detect(Layer):
    """Detection head: per level a 1x1 conv reshaped to (B, na, ny, nx,
    5+nc) logits (torch's anchor-major order).  With ``decode=True`` it
    returns ``(pred, raws)``: pred (B, N, 5+nc) concatenates each level's
    sigmoids decoded to pixels, xy = (2s - 0.5 + grid) * stride, wh =
    (2s)^2 * anchor, in the logits' dtype (``lpr_tpu/models/yolo.py:822-849``).
    The grid and anchor tables are built once per level, dtype and device,
    so a captured step uploads none."""

    def __init__(self, nc: int, anchors, strides: Sequence[int] = ()):
        super().__init__()
        self.anchors = np.asarray(anchors, np.float32)  # (nl, na, 2) grid
        self.nl, self.na = self.anchors.shape[:2]
        self.no = nc + 5
        self.strides = tuple(strides)
        self._tables: Dict[Any, Tuple[Tensor, Tensor]] = {}

    def load(self, state, prefix):
        self.m = torch.nn.ModuleList([
            tnn.Conv2d.from_hwio(state[f"{prefix}/m/{l}/w"],
                                 state[f"{prefix}/m/{l}/b"], padding=0)
            for l in range(self.nl)])

    @torch.inference_mode(False)
    def _grid_anchors(self, l: int, ny: int, nx: int, dtype, device):
        key = (l, ny, nx, dtype, device)
        if key not in self._tables:
            gy, gx = torch.meshgrid(
                torch.arange(ny, device=device).to(dtype),
                torch.arange(nx, device=device).to(dtype), indexing="ij")
            anc = torch.from_numpy(self.anchors[l] * np.float32(
                self.strides[l])).to(device, dtype)
            self._tables[key] = (torch.stack([gx, gy], -1),
                                 anc[None, :, None, None, :])
        return self._tables[key]

    def forward(self, xs, decode: bool = False):
        if not isinstance(xs, (list, tuple)):
            xs = [xs]
        raws, outs = [], []
        for l, (conv, x) in enumerate(zip(self.m, xs)):
            y = conv(x)
            B, ny, nx, _ = y.shape
            y = y.reshape(B, ny, nx, self.na, self.no).permute(0, 3, 1, 2, 4)
            raws.append(y)
            if decode:
                s = float(self.strides[l])
                grid, anc = self._grid_anchors(l, ny, nx, y.dtype, y.device)
                sig = torch.sigmoid(y)
                xy = (sig[..., 0:2] * 2.0 - 0.5 + grid) * s
                wh = (sig[..., 2:4] * 2.0) ** 2 * anc
                out = torch.cat([xy, wh, sig[..., 4:]], -1)
                outs.append(out.reshape(B, self.na * ny * nx, self.no))
        if decode:
            return torch.cat(outs, 1), raws
        return raws


@dataclasses.dataclass(frozen=True)
class YoloSpec:
    """Architecture spec: same grammar as the reference yaml files."""

    nc: int
    depth_multiple: float
    width_multiple: float
    anchors: Any
    backbone: Tuple[tuple, ...]
    head: Tuple[tuple, ...]
    ch: int = 3


class YoloModel(torch.nn.Module):
    """A built layer plan.  ``forward(x)`` maps an NHWC batch to the raw
    per-scale Detect logits, ``forward(x, decode=True)`` to ``(pred,
    raws)`` as the JAX ``apply`` does.  Call :meth:`load_state` before
    use."""

    def __init__(self, spec: YoloSpec, layers: List[Layer], save: List[int],
                 strides: Tuple[int, ...], anchors_grid: np.ndarray):
        super().__init__()
        self.spec = spec
        self.layers = torch.nn.ModuleList(layers)
        self.save = save
        self.strides = strides
        self.anchors = anchors_grid  # (nl, na, 2) grid units
        self.amax_plan: Optional[AmaxPlan] = None   # quantize_yolo's

    @property
    def nc(self) -> int:
        return self.spec.nc

    def load_state(self, state: State) -> "YoloModel":
        for l in self.layers:
            l.load(state, str(l.i))
        return self

    def forward(self, x: Optional[Tensor], front=None, mid=None,
                packed: Optional[Tensor] = None, decode: bool = False):
        """``front``: packed weights from
        :func:`lpr_tpu_torch.kernels.yolo_front.front_pack` — layers 0-2 then
        run as the fused front kernel K1 (``lpr_tpu/models/yolo.py:975-986``);
        ``mid`` (with ``front``): packed weights from
        :func:`lpr_tpu_torch.kernels.yolo_mid.mid_pack` — layers 3-4 then
        run as K3 (``:987-999``).  ``packed`` (with ``front`` packed at
        ``input_scale=1/255``): the letterboxed uint8 frames (B, H, W, 3)
        (:func:`lpr_tpu_torch.ops.image.letterbox_host`), which K1 takes in
        place of ``x`` (ignored, may be None), the counterpart of
        ``apply(..., packed_frames=, packed_hw=)`` (``:938-986``).
        ``decode``: the Detect head's decoded predictions as well
        (:class:`Detect`)."""
        if packed is not None:
            if front is None:
                raise ValueError("packed frames go through the fused front: "
                                 "pass front as well")
            x = packed
        if front is None:
            if mid is not None:
                raise ValueError("the fused mid runs on the fused front's "
                                 "output: pass front as well")
            return self.forward_from(x, 0, decode=decode)
        from lpr_tpu_torch.kernels.yolo_front import yolo_front

        y = yolo_front(x, front)
        if mid is None:
            return self.forward_from(y, 3, decode=decode)
        from lpr_tpu_torch.kernels.yolo_mid import yolo_mid

        return self.forward_from(yolo_mid(y, mid), 5, decode=decode)

    def forward_from(self, y, start: int, stop: Optional[int] = None,
                     decode: bool = False):
        """Run layers ``start:stop`` on ``y``, the output of layer
        ``start - 1`` (kept as that layer's saved output where a later
        layer reads it; no earlier saved output may be needed), and return
        the last one's output.  A quantized model's plan slots
        (:func:`plan_amax`) are zeroed once here for the forward."""
        if any(j < start - 1 for j in self.save):
            raise ValueError(f"a layer before {start - 1} is read later")
        plan = self.amax_plan
        if plan is not None:
            if plan.start != start:
                plan_amax(self, start)
            plan.buf = torch.zeros((plan.n,), dtype=torch.float32,
                                   device=y.device)
        try:
            return self._run(y, start, stop, decode)
        finally:
            if plan is not None:
                plan.buf = None

    def _run(self, y, start: int, stop: Optional[int], decode: bool):
        saved: Dict[int, Any] = {}
        if start and (start - 1) in self.save:
            saved[start - 1] = y
        n = len(self.layers)
        for l in self.layers[start:stop]:
            if l.f != -1:
                if isinstance(l.f, int):
                    y = saved[l.f % n]
                else:
                    y = [y if j == -1 else saved[j % n] for j in l.f]
            y = l(y, decode=decode) if isinstance(l, Detect) else l(y)
            if l.i in self.save:
                saved[l.i] = y
        return y


def plan_amax(model: YoloModel, start: int) -> AmaxPlan:
    """Plan the exact max|x| of every int8 conv's input for a forward from
    layer ``start`` (``forward_from``'s ``f``/``save`` wiring), into
    ``model.amax_plan``: an I2 epilogue's output has its own slot; a
    ``Concat`` the max of its parts' slots; an ``Upsample`` its source's;
    SPPF's concat of ``y`` and its max-pools ``y``'s; a shortcut fused into
    the int8 cv2 its epilogue's.  Where no slot holds the max (layer
    ``start - 1``'s output, made outside the plan: K1's or K3's; a float
    conv's or a residual add's output; any layer kind that does not plan
    itself, :meth:`Layer.plan_amax`) I1's max pass fills one.  An output
    slot that no quantize reads is dropped, so that epilogue takes no max.
    For yolov5s from layer 3: one max pass, 43 quantizes, 50 I2s."""
    plan = model.amax_plan or AmaxPlan()
    plan.n, plan.start = 0, start
    convs = [m for m in model.modules() if isinstance(m, ConvAct)]
    for m in convs:
        m.in_plan, m.out_slot, m.plan = None, None, None
    descs: Dict[int, Any] = {}
    n = len(model.layers)
    d = None
    for l in model.layers[start:]:
        if l.f != -1:
            d = (descs.get(l.f % n) if isinstance(l.f, int) else
                 [d if j == -1 else descs.get(j % n) for j in l.f])
        d = l.plan_amax(d, plan)
        if l.i in model.save:
            descs[l.i] = d
    read = {k for m in convs if m.in_plan is not None for k in m.in_plan[0]}
    for m in convs:
        if m.out_slot not in read:
            m.out_slot = None
    model.amax_plan = plan
    return plan


def quantize_yolo(model: YoloModel, min_contract: int = 64) -> YoloModel:
    """Post-training int8 quantization of a detector's convolutions, in
    place (``lpr_tpu/models/yolo.py:1018-1072``): every eligible conv gets
    per-output-channel int8 weights of its BN-folded float weight and runs
    :func:`tnn.conv2d_int8`, activations quantized per tensor at run time,
    each input's max|x| carried from the layers that wrote it where the
    structure shows it exactly (:func:`plan_amax`).
    Skipped, as in the JAX package: the Detect head; the S2D stem conv (and
    the S2D downsamplers, off in the JAX package); depthwise convs and any
    conv with Cin/groups == 1; convs with K = kh * kw * Cin/groups <
    ``min_contract``.  Quantize the float32 weights as loaded (the
    recognizer does so before it casts the model to its dtype); a conv
    already quantized keeps its codes.  Returns ``model``."""
    for layer in model.layers:
        if isinstance(layer, Detect) or (isinstance(layer, Conv)
                                         and layer._is_s2d_stem()):
            continue
        for m in layer.modules():
            if isinstance(m, ConvAct) and m.int8_eligible(min_contract):
                m.quantize()
    plan_amax(model, 0)
    return model


def quantized_convs(model: YoloModel) -> Dict[str, ConvAct]:
    """The model's quantized convs by checkpoint path (``2/m/0/cv2``)."""
    return {m.prefix: m for m in model.modules()
            if isinstance(m, ConvAct) and m.quantized}


_MODULES = {
    "Conv": Conv, "DWConv": DWConv, "Focus": Focus,
    "Bottleneck": BottleneckLayer, "BottleneckCSP": BottleneckCSP, "C3": C3,
    "C3TR": C3TR, "C3SPP": C3SPP, "C3Ghost": C3Ghost,
    "GhostConv": GhostConv, "GhostBottleneck": GhostBottleneck, "SPP": SPP,
    "SPPF": SPPF, "Concat": Concat, "Contract": Contract, "Expand": Expand,
    "nn.Upsample": Upsample, "Upsample": Upsample, "Detect": Detect,
    "Classify": Classify,
}
_WIDTH_SCALED = (Conv, DWConv, Focus, BottleneckLayer, GhostBottleneck, SPP,
                 SPPF, GhostConv, BottleneckCSP, C3, C3TR, C3SPP, C3Ghost)


def _arg(args, i, default):
    return args[i] if len(args) > i else default


def build_yolo(spec: YoloSpec, ckpt_anchors: Optional[np.ndarray] = None,
               strides: Optional[Sequence[int]] = None) -> YoloModel:
    """The ``parse_model`` equivalent: width/depth scaling, from-index
    wiring and channel propagation, for every module name of the JAX
    builder (``lpr_tpu/models/yolo.py:1075-1175``)."""
    gd, gw = spec.depth_multiple, spec.width_multiple
    ch = [spec.ch]
    layers: List[Layer] = []
    save: List[int] = []
    for i, (f, n, mname, args) in enumerate(list(spec.backbone)
                                            + list(spec.head)):
        if mname not in _MODULES:
            raise ValueError(f"unknown module {mname!r}")
        cls = _MODULES[mname]
        n_scaled = max(round(n * gd), 1) if n > 1 else n
        c1 = ch[f if isinstance(f, int) else f[0]]
        if cls in _WIDTH_SCALED:
            c2 = make_divisible(args[0] * gw, 8)
            if cls is C3SPP:
                lay = C3SPP(c1, c2, n=n_scaled,
                            k=tuple(_arg(args, 1, (5, 9, 13))))
            elif cls in (BottleneckCSP, C3, C3TR, C3Ghost):
                lay = cls(c1, c2, n=n_scaled, shortcut=_arg(args, 1, True))
            elif cls is SPP:
                lay = SPP(c1, c2, tuple(_arg(args, 1, (5, 9, 13))))
            elif cls is SPPF:
                lay = SPPF(c1, c2, _arg(args, 1, 5))
            elif cls in (Conv, DWConv):
                lay = cls(c1, c2, _arg(args, 1, 1), _arg(args, 2, 1),
                          _arg(args, 3, None))
            elif cls in (Focus, GhostConv):
                lay = cls(c1, c2, _arg(args, 1, 1), _arg(args, 2, 1))
            elif cls is GhostBottleneck:
                lay = cls(c1, c2, _arg(args, 1, 3), _arg(args, 2, 1))
            else:  # BottleneckLayer
                lay = cls(c1, c2, _arg(args, 1, True))
        elif cls is Concat:
            c2 = sum(ch[j] for j in f)
            lay = Concat()
        elif cls is Upsample:
            c2 = c1
            lay = Upsample(int(_arg(args, 1, 2)))
        elif cls in (Contract, Expand):
            g = args[0] if args else 2
            c2 = c1 * g * g if cls is Contract else c1 // (g * g)
            lay = cls(g)
        elif cls is Classify:
            c2 = args[0]
            lay = Classify(c1, c2)
        else:  # Detect
            if strides is None:
                raise ValueError("Detect needs strides")
            if ckpt_anchors is not None:
                anchors_grid = np.asarray(ckpt_anchors, np.float32)
            elif isinstance(spec.anchors, int):
                anchors_grid = np.ones((len(f), spec.anchors, 2), np.float32)
            else:
                a = np.asarray(spec.anchors, np.float32).reshape(len(f), -1, 2)
                st = np.asarray(strides, np.float32).reshape(-1, 1, 1)
                anchors_grid = a / st
            lay = Detect(spec.nc, anchors_grid, strides)
            lay.ch = tuple(ch[j] for j in f)    # the input channels
            c2 = c1
        lay.i, lay.f = i, f
        layers.append(lay)
        save.extend(j % i for j in ([f] if isinstance(f, int) else f)
                    if j != -1)
        if i == 0:
            ch = []
        ch.append(c2)
    det = layers[-1]
    return YoloModel(spec, layers, sorted(set(save)),
                     tuple(strides or ()), getattr(det, "anchors", None))


def yolov5_spec(nc: int = 80, depth: float = 0.33, width: float = 0.5,
                anchors=None) -> YoloSpec:
    """Standard 3-scale YOLOv5 v6.0 (reference models/yolov5s.yaml)."""
    if anchors is None:
        anchors = [[10, 13, 16, 30, 33, 23],
                   [30, 61, 62, 45, 59, 119],
                   [116, 90, 156, 198, 373, 326]]
    backbone = (
        (-1, 1, "Conv", [64, 6, 2, 2]),
        (-1, 1, "Conv", [128, 3, 2]),
        (-1, 3, "C3", [128]),
        (-1, 1, "Conv", [256, 3, 2]),
        (-1, 6, "C3", [256]),
        (-1, 1, "Conv", [512, 3, 2]),
        (-1, 9, "C3", [512]),
        (-1, 1, "Conv", [1024, 3, 2]),
        (-1, 3, "C3", [1024]),
        (-1, 1, "SPPF", [1024, 5]),
    )
    head = (
        (-1, 1, "Conv", [512, 1, 1]),
        (-1, 1, "nn.Upsample", [None, 2, "nearest"]),
        ([-1, 6], 1, "Concat", [1]),
        (-1, 3, "C3", [512, False]),
        (-1, 1, "Conv", [256, 1, 1]),
        (-1, 1, "nn.Upsample", [None, 2, "nearest"]),
        ([-1, 4], 1, "Concat", [1]),
        (-1, 3, "C3", [256, False]),
        (-1, 1, "Conv", [256, 3, 2]),
        ([-1, 14], 1, "Concat", [1]),
        (-1, 3, "C3", [512, False]),
        (-1, 1, "Conv", [512, 3, 2]),
        ([-1, 10], 1, "Concat", [1]),
        (-1, 3, "C3", [1024, False]),
        ([17, 20, 23], 1, "Detect", ["nc", "anchors"]),
    )
    return YoloSpec(nc, depth, width, anchors, backbone, head)


def char_ocr_spec() -> YoloSpec:
    """Single-scale stride-8 char OCR architecture: Focus stem, SPP, C3TR
    tail, PAN up-path, Detect on P3 only with 2 evolved anchors."""
    backbone = (
        (-1, 1, "Focus", [32, 3]),
        (-1, 1, "Conv", [64, 3, 2]),
        (-1, 3, "C3", [64]),
        (-1, 1, "Conv", [128, 3, 2]),
        (-1, 9, "C3", [128]),
        (-1, 1, "Conv", [256, 3, 2]),
        (-1, 9, "C3", [256]),
        (-1, 1, "Conv", [512, 3, 2]),
        (-1, 1, "SPP", [512, [5, 9, 13]]),
        (-1, 3, "C3TR", [512, False]),
    )
    head = (
        (-1, 1, "Conv", [256, 1, 1]),
        (-1, 1, "nn.Upsample", [None, 2, "nearest"]),
        ([-1, 6], 1, "Concat", [1]),
        (-1, 3, "C3", [256, False]),
        (-1, 1, "Conv", [128, 1, 1]),
        (-1, 1, "nn.Upsample", [None, 2, "nearest"]),
        ([-1, 4], 1, "Concat", [1]),
        (-1, 3, "C3", [128, False]),
        ([17], 1, "Detect", ["nc", "anchors"]),
    )
    return YoloSpec(36, 0.33, 0.5, 2, backbone, head)


def yolov5_p6_spec(nc: int = 80, depth: float = 0.33, width: float = 0.5,
                   anchors=None) -> YoloSpec:
    """4-scale P6/64 variant (reference models/hub/yolov5s6.yaml): a 768-ch
    P5 stage before the 1024-ch P6 + SPPF, three up and three down PAN
    steps, Detect on P3-P6 (strides 8/16/32/64; a 64-multiple input)."""
    if anchors is None:
        anchors = [[19, 27, 44, 40, 38, 94],
                   [96, 68, 86, 152, 180, 137],
                   [140, 301, 303, 264, 238, 542],
                   [436, 615, 739, 380, 925, 792]]
    backbone = (
        (-1, 1, "Conv", [64, 6, 2, 2]),
        (-1, 1, "Conv", [128, 3, 2]),
        (-1, 3, "C3", [128]),
        (-1, 1, "Conv", [256, 3, 2]),
        (-1, 6, "C3", [256]),
        (-1, 1, "Conv", [512, 3, 2]),
        (-1, 9, "C3", [512]),
        (-1, 1, "Conv", [768, 3, 2]),
        (-1, 3, "C3", [768]),
        (-1, 1, "Conv", [1024, 3, 2]),
        (-1, 3, "C3", [1024]),
        (-1, 1, "SPPF", [1024, 5]),
    )
    head = (
        (-1, 1, "Conv", [768, 1, 1]),
        (-1, 1, "nn.Upsample", [None, 2, "nearest"]),
        ([-1, 8], 1, "Concat", [1]),
        (-1, 3, "C3", [768, False]),
        (-1, 1, "Conv", [512, 1, 1]),
        (-1, 1, "nn.Upsample", [None, 2, "nearest"]),
        ([-1, 6], 1, "Concat", [1]),
        (-1, 3, "C3", [512, False]),
        (-1, 1, "Conv", [256, 1, 1]),
        (-1, 1, "nn.Upsample", [None, 2, "nearest"]),
        ([-1, 4], 1, "Concat", [1]),
        (-1, 3, "C3", [256, False]),
        (-1, 1, "Conv", [256, 3, 2]),
        ([-1, 20], 1, "Concat", [1]),
        (-1, 3, "C3", [512, False]),
        (-1, 1, "Conv", [512, 3, 2]),
        ([-1, 16], 1, "Concat", [1]),
        (-1, 3, "C3", [768, False]),
        (-1, 1, "Conv", [768, 3, 2]),
        ([-1, 12], 1, "Concat", [1]),
        (-1, 3, "C3", [1024, False]),
        ([23, 26, 29, 32], 1, "Detect", ["nc", "anchors"]),
    )
    return YoloSpec(nc, depth, width, anchors, backbone, head)


# (depth, width) multiples of the named sizes.
_SIZE_PRESETS = {
    "n": (0.33, 0.25), "s": (0.33, 0.50), "m": (0.67, 0.75),
    "l": (1.00, 1.00), "x": (1.33, 1.25),
}


def yolov5(size: str = "s", nc: int = 80, strides=None) -> YoloModel:
    """The named zoo, built (call :meth:`YoloModel.load_state` before use):
    yolov5{n,s,m,l,x} and the P6 variants yolov5{n,s,m,l,x}6."""
    p6 = size.endswith("6")
    base = size[:-1] if p6 else size
    if base not in _SIZE_PRESETS:
        raise ValueError(
            f"unknown yolov5 size {size!r}: expected one of "
            f"{sorted(_SIZE_PRESETS)} or their P6 variants ('n6'..'x6')")
    depth, width = _SIZE_PRESETS[base]
    if strides is None:
        strides = (8, 16, 32, 64) if p6 else (8, 16, 32)
    spec_fn = yolov5_p6_spec if p6 else yolov5_spec
    return build_yolo(spec_fn(nc=nc, depth=depth, width=width),
                      strides=strides)


def apply_augmented(model: YoloModel, x: Tensor) -> Tensor:
    """Test-time augmentation (``lpr_tpu/models/yolo.py:1329-1366``): the
    decoded predictions at scales 1, 0.83 (flipped left-right) and 0.67,
    rescaled to the input's pixels, with the augmented tails clipped.  The
    downscales are ``jax.image.resize``'s antialiased bilinear
    (:func:`lpr_tpu_torch.ops.image.resize_bilinear`).  x: (B, H, W, 3)."""
    from lpr_tpu_torch.ops.image import resize_bilinear

    h, w = int(x.shape[1]), int(x.shape[2])
    gs = int(max(model.strides))
    preds = []
    for si, flip in zip((1.0, 0.83, 0.67), (False, True, False)):
        xi = torch.flip(x, (2,)) if flip else x
        if si != 1.0:
            nh = math.ceil(h * si / gs) * gs
            nw = math.ceil(w * si / gs) * gs
            xi = resize_bilinear(xi, (nh, nw))
        pred = model(xi, decode=True)[0].float()
        scale_back = (xi.shape[2] / w) if si != 1.0 else 1.0
        xy = pred[..., 0:2] / scale_back
        wh = pred[..., 2:4] / scale_back
        if flip:
            xy = torch.stack([w - xy[..., 0], xy[..., 1]], -1)
        preds.append(torch.cat([xy, wh, pred[..., 4:]], -1))
    nl = len(model.strides)
    g = sum(4 ** i for i in range(nl))
    i0 = preds[0].shape[1] // g     # one coarsest-level cell group
    preds[0] = preds[0][:, :preds[0].shape[1] - i0]
    ilast = preds[-1].shape[1] // g * (4 ** (nl - 1))
    preds[-1] = preds[-1][:, ilast:]
    return torch.cat(preds, 1)


class YoloEnsemble(torch.nn.Module):
    """NMS-ensemble of YOLO models (``lpr_tpu/models/yolo.py:1369-1393``):
    their decoded predictions concatenated along the box dimension, for one
    NMS pass.  Inference only: ``forward(x)`` returns ``(pred, None)``."""

    def __init__(self, models: Sequence[YoloModel]):
        super().__init__()
        if len(models) < 2:
            raise ValueError("an ensemble needs at least two models")
        if len({m.nc for m in models}) != 1:
            raise ValueError("ensemble nc mismatch")
        self.models = torch.nn.ModuleList(models)
        self.nc = models[0].nc
        # letterbox alignment uses the coarsest stride
        self.stride = max(max(m.strides) for m in models)
        self.strides = max((m.strides for m in models), key=max)

    def forward(self, x: Tensor, decode: bool = True):
        if not decode:
            raise ValueError("an ensemble returns decoded predictions only")
        return torch.cat([m(x, decode=True)[0] for m in self.models], 1), None


def load_plate_detector(path: str, device: DeviceLike = "cuda",
                        size: str = "s", nc: int = 11) -> YoloModel:
    """A plate detector (``yolov5(size)``, nc=11, strides 8/16/32) from a
    flat npz checkpoint: ``checkpoints/plate_det640.npz`` and
    ``demo_plate_s.npz`` (size "s", the default) or ``demo_plate.npz``
    ("n")."""
    dev = resolve_device(device)
    state, _ = load_state(path)
    return yolov5(size, nc=nc).load_state(state).to(dev).eval()


def load_char_ocr_npz(path: str, device: DeviceLike = "cuda"):
    """The char OCR model (``char_ocr_spec``) from a flat npz checkpoint
    with its anchors under ``__anchors__`` (grid units).  Returns
    ``(model, state, ck)`` like :func:`load_yolo_torch`, with ``ck.names``
    the 36 OCR class names."""
    import types

    from lpr_tpu_torch.pipeline.chars import OCR_CLASSES

    dev = resolve_device(device)
    state, side = load_state(path)
    anchors = side.get("__anchors__")
    model = build_yolo(char_ocr_spec(), ckpt_anchors=(
        None if anchors is None else np.asarray(anchors, np.float32)),
        strides=(8,))
    ck = types.SimpleNamespace(names=list(OCR_CLASSES), yaml={}, path=path)
    return model.load_state(state).to(dev).eval(), state, ck


# ---------------------------------------------------------------------------
# import of the reference's pickled-Model checkpoints (.pt)


def torch_names(model: YoloModel, prefix: str = "model"
                ) -> List[Tuple[str, str, str]]:
    """Where each entry of the flat state lives in a YOLOv5 ``.pt``'s state
    dict, by layer plan (the JAX layers' ``import_torch``,
    ``lpr_tpu/models/yolo.py:119-820``): ``(kind, state key, torch name)``.
    Kinds: ``conv`` a Conv(+BN) block at a torch prefix (``.conv.weight``
    with ``.bn.*`` or ``.conv.bias``; ``conv?`` the same where the block may
    be absent), ``w`` a bare conv weight, ``vec`` a vector, ``lin`` a
    Linear weight, ``bn`` a standalone batch norm at a torch prefix."""
    out: List[Tuple[str, str, str]] = []

    def conv(k, p, kind="conv"):
        out.append((kind, k, p))

    def pair(k, p):
        conv(f"{k}/cv1", f"{p}.cv1")
        conv(f"{k}/cv2", f"{p}.cv2")

    def ghost_bottleneck(k, p, s):
        pair(f"{k}/g1", f"{p}.conv.0")
        pair(f"{k}/g2", f"{p}.conv.2")
        if s == 2:
            conv(f"{k}/dw", f"{p}.conv.1")
            conv(f"{k}/sc_dw", f"{p}.shortcut.0")
            conv(f"{k}/sc_pw", f"{p}.shortcut.1")

    def transformer(k, p, n):
        conv(f"{k}/conv", f"{p}.conv", "conv?")
        out.append(("lin", f"{k}/linear/w", f"{p}.linear.weight"))
        out.append(("vec", f"{k}/linear/b", f"{p}.linear.bias"))
        for j in range(n):
            t = f"{p}.tr.{j}"
            for key, name, kind in (
                    ("q", "q.weight", "lin"), ("k", "k.weight", "lin"),
                    ("v", "v.weight", "lin"),
                    ("in_proj_w", "ma.in_proj_weight", "lin"),
                    ("in_proj_b", "ma.in_proj_bias", "vec"),
                    ("out_proj_w", "ma.out_proj.weight", "lin"),
                    ("out_proj_b", "ma.out_proj.bias", "vec"),
                    ("fc1", "fc1.weight", "lin"),
                    ("fc2", "fc2.weight", "lin")):
                out.append((kind, f"{k}/tr/{j}/{key}", f"{t}.{name}"))

    for lay in model.layers:
        k, p = str(lay.i), f"{prefix}.{lay.i}"
        if isinstance(lay, Focus):
            conv(k, f"{p}.conv")
        elif isinstance(lay, Conv):                  # DWConv too
            conv(k, p)
        elif isinstance(lay, BottleneckLayer):
            pair(k, p)
        elif isinstance(lay, C3):
            pair(k, p)
            conv(f"{k}/cv3", f"{p}.cv3")
            if isinstance(lay, C3TR):
                transformer(f"{k}/m", f"{p}.m", lay.n)
            elif isinstance(lay, C3SPP):
                pair(f"{k}/m", f"{p}.m")
            elif isinstance(lay, C3Ghost):
                for j in range(lay.n):
                    ghost_bottleneck(f"{k}/m/{j}", f"{p}.m.{j}", 1)
            else:
                for j in range(lay.n):
                    pair(f"{k}/m/{j}", f"{p}.m.{j}")
        elif isinstance(lay, BottleneckCSP):
            conv(f"{k}/cv1", f"{p}.cv1")
            out.append(("w", f"{k}/cv2/w", f"{p}.cv2.weight"))
            out.append(("w", f"{k}/cv3/w", f"{p}.cv3.weight"))
            conv(f"{k}/cv4", f"{p}.cv4")
            out.append(("bn", f"{k}/bn", f"{p}.bn"))
            for j in range(lay.n):
                pair(f"{k}/m/{j}", f"{p}.m.{j}")
        elif isinstance(lay, (SPP, SPPF, GhostConv)):
            pair(k, p)
        elif isinstance(lay, GhostBottleneck):
            ghost_bottleneck(k, p, lay.s)
        elif isinstance(lay, Classify):
            out.append(("w", f"{k}/w", f"{p}.conv.weight"))
            out.append(("vec", f"{k}/b", f"{p}.conv.bias"))
        elif isinstance(lay, Detect):
            for l in range(lay.nl):
                out.append(("w", f"{k}/m/{l}/w", f"{p}.m.{l}.weight"))
                out.append(("vec", f"{k}/m/{l}/b", f"{p}.m.{l}.bias"))
    return out


_BN_NAMES = (("gamma", "weight"), ("beta", "bias"), ("mean", "running_mean"),
             ("var", "running_var"))


def state_from_torch(model: YoloModel, sd: Dict[str, np.ndarray],
                     fuse: bool = True, prefix: str = "model") -> State:
    """A YOLOv5 ``.pt``'s state dict (:class:`~lpr_tpu_torch.weights
    .torch_ckpt.YoloCheckpoint`'s ``state_dict``) as the flat state of
    ``model``'s layer plan, equal key for key and bit for bit to the
    flattened params of the JAX ``YoloModel.import_torch``: conv weights
    HWIO, Linear weights (in, out); ``fuse`` folds each conv's batch norm
    into ``w`` and ``b`` (``fuse_conv_bn``), else keeps it under ``bn/*``
    (:meth:`YoloModel.load_state` folds it then)."""
    from lpr_tpu_torch.weights import convert as cvt

    out: State = {}
    for kind, k, name in torch_names(model, prefix):
        if kind in ("conv", "conv?"):
            if kind == "conv?" and f"{name}.conv.weight" not in sd:
                continue
            w = cvt.conv_w(sd[f"{name}.conv.weight"])
            if f"{name}.bn.weight" in sd:
                bn = [cvt.vec(sd[f"{name}.bn.{t}"]) for _, t in _BN_NAMES]
                if fuse:
                    out[f"{k}/w"], out[f"{k}/b"] = tnn.fuse_conv_bn(w, None,
                                                                    *bn)
                    continue
                for (key, _), v in zip(_BN_NAMES, bn):
                    out[f"{k}/bn/{key}"] = v
            elif f"{name}.conv.bias" in sd:
                out[f"{k}/b"] = cvt.vec(sd[f"{name}.conv.bias"])
            out[f"{k}/w"] = w
        elif kind == "bn":
            for key, t in _BN_NAMES:
                out[f"{k}/{key}"] = cvt.vec(sd[f"{name}.{t}"])
        else:
            fn = {"w": cvt.conv_w, "vec": cvt.vec, "lin": cvt.linear_w}[kind]
            out[k] = fn(sd[name])
    return out


def spec_from_yaml(yaml: Dict[str, Any], nc: int) -> YoloSpec:
    """The architecture yaml a YOLOv5 checkpoint embeds as a
    :class:`YoloSpec` (``lpr_tpu/models/yolo.py:1425-1438``)."""
    def rows(rs):
        return tuple((r[0] if not isinstance(r[0], list) else list(r[0]),
                      int(r[1]), str(r[2]), list(r[3])) for r in rs)

    return YoloSpec(
        nc=nc, depth_multiple=float(yaml.get("depth_multiple", 1.0)),
        width_multiple=float(yaml.get("width_multiple", 1.0)),
        anchors=yaml.get("anchors"), backbone=rows(yaml["backbone"]),
        head=rows(yaml["head"]), ch=int(yaml.get("ch", 3)))


def load_yolo_torch(path, fuse: bool = True, device: DeviceLike = "cuda"):
    """Any YOLOv5 ``.pt`` (a pickled ``Model``, the reference's
    ``attempt_load`` input), read without running pickled code
    (``lpr_tpu/models/yolo.py:1396-1449``): the spec from the checkpoint's
    own yaml, anchors from the Detect buffer (AutoAnchor-evolved values
    survive), strides from the saved stride tensor.  Returns ``(model,
    state, ck)``: the model loaded on ``device``, its flat state
    (:func:`state_from_torch`) and the
    :class:`~lpr_tpu_torch.weights.torch_ckpt.YoloCheckpoint`.

    A list of paths gives a :class:`YoloEnsemble`, the list of states and
    the LAST checkpoint (whose names the reference adopts)."""
    from lpr_tpu_torch.weights.torch_ckpt import YoloCheckpoint

    if isinstance(path, (list, tuple)):
        if len(path) == 1:
            return load_yolo_torch(path[0], fuse=fuse, device=device)
        loaded = [load_yolo_torch(p, fuse=fuse, device=device) for p in path]
        return (YoloEnsemble([m for m, _, _ in loaded]),
                [s for _, s, _ in loaded], loaded[-1][2])
    dev = resolve_device(device)
    ck = YoloCheckpoint(path)
    if not ck.yaml.get("backbone"):
        raise ValueError(f"{path}: no architecture yaml in checkpoint")
    spec = spec_from_yaml(ck.yaml, ck.nc)
    if ck.stride is not None:
        strides = tuple(int(s) for s in np.asarray(ck.stride).ravel())
    else:  # from the number of Detect inputs (P3 up)
        strides = tuple(8 * 2 ** i for i in range(len(spec.head[-1][0])))
    model = build_yolo(spec, ckpt_anchors=ck.anchors, strides=strides)
    state = state_from_torch(model, ck.state_dict, fuse=fuse)
    return model.load_state(state).to(dev).eval(), state, ck


def load_char_ocr(path: str, fuse: bool = True, device: DeviceLike = "cuda"):
    """The char OCR model from the reference's ``char.pt``
    (:func:`load_yolo_torch`) or from the repo's npz checkpoint
    (:func:`load_char_ocr_npz`), as ``lpr_tpu.models.yolo.load_char_ocr``
    takes either.  Returns ``(model, state, ck)``; ``ck.names`` are the
    class names (for an npz, the 36 OCR classes)."""
    if str(path).endswith(".npz"):
        return load_char_ocr_npz(path, device=device)
    return load_yolo_torch(path, fuse=fuse, device=device)
