"""Plain YOLOv5 forward (NCHW, float32) from the repo's flat npz state:
the plate detector (yolov5s v6.0, nc=11, strides 8/16/32) and the char OCR
(Focus, SPP and C3TR backbone, one Detect level at stride 8), as the
published YOLOv5 ``models/yolo.py`` and ``models/common.py`` define their
layers, with batch norm folded at load.  Returns the raw Detect logits of
each level, (B, na, ny, nx, 5 + nc).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from lprbench.ref import nn as rn

Tensor = torch.Tensor

# [from, number, module, args] rows of yolov5s.yaml (v6.0) and of the char
# OCR's yaml; depth 0.33, width 0.5.
YOLOV5S = (
    (-1, 1, "Conv", [64, 6, 2, 2]), (-1, 1, "Conv", [128, 3, 2]),
    (-1, 3, "C3", [128]), (-1, 1, "Conv", [256, 3, 2]), (-1, 6, "C3", [256]),
    (-1, 1, "Conv", [512, 3, 2]), (-1, 9, "C3", [512]),
    (-1, 1, "Conv", [1024, 3, 2]), (-1, 3, "C3", [1024]),
    (-1, 1, "SPPF", [1024, 5]),
    (-1, 1, "Conv", [512, 1, 1]), (-1, 1, "Upsample", []),
    ([-1, 6], 1, "Concat", []), (-1, 3, "C3", [512, False]),
    (-1, 1, "Conv", [256, 1, 1]), (-1, 1, "Upsample", []),
    ([-1, 4], 1, "Concat", []), (-1, 3, "C3", [256, False]),
    (-1, 1, "Conv", [256, 3, 2]), ([-1, 14], 1, "Concat", []),
    (-1, 3, "C3", [512, False]), (-1, 1, "Conv", [512, 3, 2]),
    ([-1, 10], 1, "Concat", []), (-1, 3, "C3", [1024, False]),
    ([17, 20, 23], 1, "Detect", []),
)
CHAR_OCR = (
    (-1, 1, "Focus", [32, 3]), (-1, 1, "Conv", [64, 3, 2]),
    (-1, 3, "C3", [64]), (-1, 1, "Conv", [128, 3, 2]), (-1, 9, "C3", [128]),
    (-1, 1, "Conv", [256, 3, 2]), (-1, 9, "C3", [256]),
    (-1, 1, "Conv", [512, 3, 2]), (-1, 1, "SPP", [512, [5, 9, 13]]),
    (-1, 3, "C3TR", [512, False]),
    (-1, 1, "Conv", [256, 1, 1]), (-1, 1, "Upsample", []),
    ([-1, 6], 1, "Concat", []), (-1, 3, "C3", [256, False]),
    (-1, 1, "Conv", [128, 1, 1]), (-1, 1, "Upsample", []),
    ([-1, 4], 1, "Concat", []), (-1, 3, "C3", [128, False]),
    ([17], 1, "Detect", []),
)
YOLOV5_ANCHORS_PX = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119),
                     (116, 90, 156, 198, 373, 326))
DEPTH, WIDTH = 0.33, 0.5


class Yolo:
    """One YOLOv5 model: ``raw(x)`` maps an NCHW float32 batch in [0, 1]
    to the per-level raw logits; ``anchors_px`` (nl, na, 2) and
    ``strides`` serve the decode."""

    def __init__(self, rows, state: Dict[str, np.ndarray], strides,
                 anchors_px, device, ar: rn.Arith):
        self.rows, self.state, self.dev, self.ar = rows, state, device, ar
        self.strides = tuple(float(s) for s in strides)
        self.anchors_px = np.asarray(anchors_px, np.float32).reshape(
            len(strides), -1, 2)
        self._w: Dict[str, tuple] = {}
        self.save = sorted({j % i for i, (f, *_) in enumerate(rows)
                            for j in ([f] if isinstance(f, int) else f)
                            if j != -1})

    # -- weights ----------------------------------------------------------
    def _conv(self, prefix: str, x: Tensor, k: int, s: int = 1, p=None,
              act: bool = True) -> Tensor:
        if prefix not in self._w:
            self._w[prefix] = rn.folded(self.state, prefix, self.dev)
        w, b = self._w[prefix]
        y = rn.conv(self.ar, x, w, b, s, k // 2 if p is None else p)
        return rn.silu(y) if act else y

    def _t(self, key: str) -> Tensor:
        if key not in self._w:
            self._w[key] = rn.vec(self.state[key], self.dev)
        return self._w[key]

    # -- blocks -----------------------------------------------------------
    def _bottleneck(self, pre: str, x: Tensor, shortcut: bool) -> Tensor:
        y = self._conv(f"{pre}/cv2", self._conv(f"{pre}/cv1", x, 1), 3)
        return x + y if shortcut else y

    def _c3(self, pre: str, x: Tensor, n: int, shortcut: bool,
            transformer: bool = False) -> Tensor:
        y = self._conv(f"{pre}/cv1", x, 1)
        if transformer:
            y = self._transformer(f"{pre}/m", y, n)
        else:
            for j in range(n):
                y = self._bottleneck(f"{pre}/m/{j}", y, shortcut)
        return self._conv(f"{pre}/cv3",
                          torch.cat([y, self._conv(f"{pre}/cv2", x, 1)], 1), 1)

    def _transformer(self, pre: str, x: Tensor, layers: int,
                     heads: int = 4) -> Tensor:
        """YOLOv5's TransformerBlock: a positional Linear added to the
        tokens, then per layer multi-head self-attention (q, k, v Linears
        into torch's MultiheadAttention) and two bias-free Linears, each
        with its residual.  Linear weights are (in, out)."""
        if f"{pre}/conv/w" in self.state:
            x = self._conv(f"{pre}/conv", x, 1)
        ar = self.ar
        B, C, H, W = x.shape
        t = x.flatten(2).transpose(1, 2)                  # (B, L, C)
        t = t + rn.linear(ar, t, self._t(f"{pre}/linear/w"),
                          self._t(f"{pre}/linear/b"))
        dk = C // heads
        for j in range(layers):
            p = f"{pre}/tr/{j}"
            q = rn.linear(ar, t, self._t(f"{p}/q"))
            k = rn.linear(ar, t, self._t(f"{p}/k"))
            v = rn.linear(ar, t, self._t(f"{p}/v"))
            w_in, b_in = self._t(f"{p}/in_proj_w"), self._t(f"{p}/in_proj_b")
            q = rn.linear(ar, q, w_in[:, :C], b_in[:C])
            k = rn.linear(ar, k, w_in[:, C:2 * C], b_in[C:2 * C])
            v = rn.linear(ar, v, w_in[:, 2 * C:], b_in[2 * C:])

            def heads_of(z):
                return z.reshape(B, -1, heads, dk).transpose(1, 2)

            att = torch.softmax(rn.matmul(ar, heads_of(q) / math.sqrt(dk),
                                          heads_of(k).transpose(-1, -2)), -1)
            o = rn.matmul(ar, att, heads_of(v)).transpose(1, 2).reshape(
                B, -1, C)
            t = rn.linear(ar, o, self._t(f"{p}/out_proj_w"),
                          self._t(f"{p}/out_proj_b")) + t
            t = rn.linear(ar, rn.linear(ar, t, self._t(f"{p}/fc1")),
                          self._t(f"{p}/fc2")) + t
        return t.transpose(1, 2).reshape(B, C, H, W)

    @staticmethod
    def _pool(x: Tensor, k: int) -> Tensor:
        return F.max_pool2d(x, k, 1, k // 2)

    # -- the plan ---------------------------------------------------------
    def raw(self, x: Tensor) -> List[Tensor]:
        saved: Dict[int, Tensor] = {}
        y = x
        for i, (f, n, kind, args) in enumerate(self.rows):
            pre = str(i)
            n = max(round(n * DEPTH), 1) if n > 1 else n
            if f != -1:
                y = (saved[f] if isinstance(f, int)
                     else [y if j == -1 else saved[j] for j in f])
            if kind == "Conv":
                k, s = args[1], (args[2] if len(args) > 2 else 1)
                p = args[3] if len(args) > 3 else None
                y = self._conv(pre, y, k, s, p)
            elif kind == "Focus":
                y = self._conv(pre, torch.cat(
                    [y[..., ::2, ::2], y[..., 1::2, ::2], y[..., ::2, 1::2],
                     y[..., 1::2, 1::2]], 1), args[1])
            elif kind in ("C3", "C3TR"):
                shortcut = args[1] if len(args) > 1 else True
                y = self._c3(pre, y, n, shortcut, kind == "C3TR")
            elif kind == "SPPF":
                a = self._conv(f"{pre}/cv1", y, 1)
                b = self._pool(a, args[1])
                c = self._pool(b, args[1])
                y = self._conv(f"{pre}/cv2", torch.cat(
                    [a, b, c, self._pool(c, args[1])], 1), 1)
            elif kind == "SPP":
                a = self._conv(f"{pre}/cv1", y, 1)
                y = self._conv(f"{pre}/cv2", torch.cat(
                    [a] + [self._pool(a, k) for k in args[1]], 1), 1)
            elif kind == "Upsample":
                y = y.repeat_interleave(2, 2).repeat_interleave(2, 3)
            elif kind == "Concat":
                y = torch.cat(y, 1)
            elif kind == "Detect":
                outs = []
                na = self.anchors_px.shape[1]
                for l, xl in enumerate(y):
                    o = self._conv(f"{pre}/m/{l}", xl, 1, act=False)
                    B, _, ny, nx = o.shape
                    outs.append(o.reshape(B, na, -1, ny, nx)
                                .permute(0, 1, 3, 4, 2))
                return outs
            else:
                raise ValueError(f"unknown layer {kind}")
            if i in self.save:
                saved[i] = y
        raise ValueError("the plan has no Detect layer")


def load_npz(path: str):
    """(state, side keys) of a flat npz checkpoint, parameters in float32
    and the ``__*__`` side keys as stored."""
    with np.load(path, allow_pickle=False) as z:
        raw = {k: z[k] for k in z.files}
    state = {k: v.astype(np.float32) for k, v in raw.items()
             if not k.startswith("__")}
    side = {k: v for k, v in raw.items() if k.startswith("__")}
    return state, side


def plate_detector(path: str, device, ar: rn.Arith) -> Yolo:
    state, _ = load_npz(path)
    return Yolo(YOLOV5S, state, (8, 16, 32), YOLOV5_ANCHORS_PX, device, ar)


def char_ocr(path: str, device, ar: rn.Arith) -> Yolo:
    state, side = load_npz(path)
    anchors = np.asarray(side["__anchors__"], np.float32) * 8.0  # grid -> px
    return Yolo(CHAR_OCR, state, (8,), anchors, device, ar)


def decode_candidates(raws: Sequence[Tensor], model: Yolo):
    """Per candidate, in (level, anchor, y, x) order: (xywh px, obj, class
    probabilities), float32, each (B, N, ...)."""
    xywh, obj, cls = [], [], []
    for l, r in enumerate(raws):
        B, na, ny, nx, no = r.shape
        s = torch.sigmoid(r.float())
        gy, gx = torch.meshgrid(torch.arange(ny, device=r.device),
                                torch.arange(nx, device=r.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).float()
        anc = torch.from_numpy(model.anchors_px[l]).to(r.device)
        xy = (s[..., 0:2] * 2.0 - 0.5 + grid) * model.strides[l]
        wh = (s[..., 2:4] * 2.0) ** 2 * anc[None, :, None, None, :]
        xywh.append(torch.cat([xy, wh], -1).reshape(B, -1, 4))
        obj.append(s[..., 4].reshape(B, -1))
        cls.append(s[..., 5:].reshape(B, -1, no - 5))
    return torch.cat(xywh, 1), torch.cat(obj, 1), torch.cat(cls, 1)
