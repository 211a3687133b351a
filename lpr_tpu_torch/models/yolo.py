"""YOLOv5-family detectors (counterpart of ``lpr_tpu/models/yolo.py``),
main-path subset: the plate detector (yolov5s, nc=11, 3 scales) and the char
OCR model (Focus/SPP/C3TR, stride 8).

The same spec grammar and builder (rows of ``[from, number, module, args]``
with depth/width multiples) produce a :class:`YoloModel` of
``torch.nn.Module`` layers.  Weights come from the repo's flat npz state
(:mod:`lpr_tpu_torch.weights.checkpoint`), with batch norm folded into the
convolutions at load time (``fuse_conv_bn``, eps 1e-3): the port runs
inference only.  Activations are NHWC throughout; ``Detect`` returns the
raw per-scale logits ``(B, na, ny, nx, 5+nc)`` for lazy-decode NMS.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lpr_tpu_torch.device import DeviceLike, resolve_device
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


class ConvAct(torch.nn.Module):
    """Conv(+folded BN)+SiLU, the JAX package's ``_conv``."""

    def __init__(self, state: State, prefix: str, *, k: int, stride: int = 1,
                 pad=None, groups: int = 1, act: str = "silu"):
        super().__init__()
        w, b = _folded(state, prefix)
        self.conv = tnn.Conv2d.from_hwio(
            w, b, stride=stride, padding=k // 2 if pad is None else pad,
            groups=groups)
        self.act = act

    def forward(self, x: Tensor) -> Tensor:
        y = self.conv(x)
        return tnn.silu(y) if self.act == "silu" else y


class Layer(torch.nn.Module):
    """One node of the layer plan; the builder sets ``i`` and ``f``."""

    i: int = 0
    f: Any = -1

    def load(self, state: State, prefix: str) -> None:
        """Build this layer's tensors from the flat state."""


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


class Focus(Layer):
    """Space-to-depth 2x2 + Conv."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.k, self.s = k, s

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
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


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
        y1 = self.m(self.cv1(x))
        return self.cv3(torch.cat([y1, self.cv2(x)], -1))


class SPP(Layer):
    """Spatial pyramid pooling."""

    def __init__(self, c1: int, c2: int, k: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        self.k = tuple(k)

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
        self.k = k

    def load(self, state, prefix):
        self.cv1 = ConvAct(state, f"{prefix}/cv1", k=1)
        self.cv2 = ConvAct(state, f"{prefix}/cv2", k=1)

    def forward(self, x):
        y = self.cv1(x)
        y1 = tnn.max_pool2d(y, self.k, 1, self.k // 2)
        y2 = tnn.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = tnn.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([y, y1, y2, y3], -1))


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


class Upsample(Layer):
    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return tnn.upsample_nearest(x, self.scale)


class Concat(Layer):
    def forward(self, xs):
        return torch.cat(xs, -1)


class Detect(Layer):
    """Detection head, raw output: per level a 1x1 conv reshaped to
    (B, na, ny, nx, 5+nc) logits (torch's anchor-major order)."""

    def __init__(self, nc: int, anchors):
        super().__init__()
        self.anchors = np.asarray(anchors, np.float32)  # (nl, na, 2) grid
        self.nl, self.na = self.anchors.shape[:2]
        self.no = nc + 5

    def load(self, state, prefix):
        self.m = torch.nn.ModuleList([
            tnn.Conv2d.from_hwio(state[f"{prefix}/m/{l}/w"],
                                 state[f"{prefix}/m/{l}/b"], padding=0)
            for l in range(self.nl)])

    def forward(self, xs) -> List[Tensor]:
        if not isinstance(xs, (list, tuple)):
            xs = [xs]
        raws = []
        for conv, x in zip(self.m, xs):
            y = conv(x)
            B, ny, nx, _ = y.shape
            raws.append(y.reshape(B, ny, nx, self.na, self.no)
                        .permute(0, 3, 1, 2, 4))
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
    per-scale Detect logits.  Call :meth:`load_state` before use."""

    def __init__(self, spec: YoloSpec, layers: List[Layer], save: List[int],
                 strides: Tuple[int, ...], anchors_grid: np.ndarray):
        super().__init__()
        self.spec = spec
        self.layers = torch.nn.ModuleList(layers)
        self.save = save
        self.strides = strides
        self.anchors = anchors_grid  # (nl, na, 2) grid units

    def load_state(self, state: State) -> "YoloModel":
        for l in self.layers:
            l.load(state, str(l.i))
        return self

    def forward(self, x: Tensor, front=None) -> List[Tensor]:
        """``front``: packed weights from
        :func:`lpr_tpu_torch.kernels.yolo_front.front_pack` — layers 0-2 then
        run as the fused front kernel (``lpr_tpu/models/yolo.py:975-986``)."""
        if front is None:
            return self.forward_from(x, 0)
        from lpr_tpu_torch.kernels.yolo_front import yolo_front

        return self.forward_from(yolo_front(x, front), 3)

    def forward_from(self, y, start: int) -> List[Tensor]:
        """Run layers ``start:`` on ``y``, the output of layer ``start - 1``
        (which no later layer may read from the saved outputs)."""
        if start and (start - 1) in self.save:
            raise ValueError(f"layer {start - 1} output is read later")
        saved: Dict[int, Any] = {}
        n = len(self.layers)
        for l in self.layers[start:]:
            if l.f != -1:
                if isinstance(l.f, int):
                    y = saved[l.f % n]
                else:
                    y = [y if j == -1 else saved[j % n] for j in l.f]
            y = l(y)
            if l.i in self.save:
                saved[l.i] = y
        return y


_MODULES = {
    "Conv": Conv, "Focus": Focus, "C3": C3, "C3TR": C3TR, "SPP": SPP,
    "SPPF": SPPF, "Concat": Concat, "nn.Upsample": Upsample,
    "Upsample": Upsample, "Detect": Detect,
}


def build_yolo(spec: YoloSpec, ckpt_anchors: Optional[np.ndarray] = None,
               strides: Optional[Sequence[int]] = None) -> YoloModel:
    """The ``parse_model`` equivalent: width/depth scaling, from-index
    wiring and channel propagation (``lpr_tpu/models/yolo.py`` build_yolo),
    for the modules of the main path."""
    gd, gw = spec.depth_multiple, spec.width_multiple
    ch = [spec.ch]
    layers: List[Layer] = []
    save: List[int] = []
    for i, (f, n, mname, args) in enumerate(list(spec.backbone)
                                            + list(spec.head)):
        if mname not in _MODULES:
            raise ValueError(f"module {mname!r} is not ported")
        cls = _MODULES[mname]
        n_scaled = max(round(n * gd), 1) if n > 1 else n
        c1 = ch[f if isinstance(f, int) else f[0]]
        if cls in (Conv, Focus, SPP, SPPF, C3, C3TR):
            c2 = make_divisible(args[0] * gw, 8)
            if cls in (C3, C3TR):
                lay = cls(c1, c2, n=n_scaled,
                          shortcut=args[1] if len(args) > 1 else True)
            elif cls is SPP:
                lay = SPP(c1, c2, tuple(args[1]) if len(args) > 1
                          else (5, 9, 13))
            elif cls is SPPF:
                lay = SPPF(c1, c2, args[1] if len(args) > 1 else 5)
            elif cls is Conv:
                lay = Conv(c1, c2, args[1] if len(args) > 1 else 1,
                           args[2] if len(args) > 2 else 1,
                           args[3] if len(args) > 3 else None)
            else:
                lay = Focus(c1, c2, args[1] if len(args) > 1 else 1,
                            args[2] if len(args) > 2 else 1)
        elif cls is Concat:
            c2 = sum(ch[j] for j in f)
            lay = Concat()
        elif cls is Upsample:
            c2 = c1
            lay = Upsample(int(args[1]) if len(args) > 1 else 2)
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
            lay = Detect(spec.nc, anchors_grid)
            c2 = c1
        lay.i, lay.f = i, f
        layers.append(lay)
        save.extend(j % i for j in ([f] if isinstance(f, int) else f)
                    if j != -1)
        if i == 0:
            ch = []
        ch.append(c2)
    det = layers[-1]
    return YoloModel(spec, layers, sorted(set(save)), tuple(strides),
                     det.anchors)


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


def load_plate_detector(path: str, device: DeviceLike = "cuda") -> YoloModel:
    """The plate detector (yolov5s, nc=11, strides 8/16/32) from a flat
    npz checkpoint such as ``checkpoints/plate_det640.npz``."""
    dev = resolve_device(device)
    state, _ = load_state(path)
    model = build_yolo(yolov5_spec(nc=11), strides=(8, 16, 32))
    return model.load_state(state).to(dev).eval()


def load_char_ocr_npz(path: str, device: DeviceLike = "cuda"):
    """The char OCR model (``char_ocr_spec``) from a flat npz checkpoint
    with its anchors under ``__anchors__`` (grid units).  Returns
    ``(model, names)`` with the 36 OCR class names."""
    from lpr_tpu_torch.pipeline.chars import OCR_CLASSES

    dev = resolve_device(device)
    state, side = load_state(path)
    anchors = side.get("__anchors__")
    model = build_yolo(char_ocr_spec(), ckpt_anchors=(
        None if anchors is None else np.asarray(anchors, np.float32)),
        strides=(8,))
    return model.load_state(state).to(dev).eval(), list(OCR_CLASSES)
