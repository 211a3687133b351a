"""The YOLO detectors' training route and fresh weights (counterpart of
``YoloModel.apply(..., train=True)`` and the layers' ``init`` in
``lpr_tpu/models/yolo.py``).

The serving modules of :mod:`lpr_tpu_torch.models.yolo` fold batch norm
into their convolutions when they are built, so they cannot train.  This
route runs the same layer plan (a built :class:`YoloModel`, which need not
be loaded) as functions of the flat, unfolded state held as tensors: HWIO
conv weights ``<key>/w`` (and ``<key>/b`` where a conv has a bias), batch
norm under ``<key>/bn/{gamma,beta,mean,var}``, the Detect convs under
``<i>/m/<l>/{w,b}``, the transformer's Linear weights (in, out).  Every
conv's batch norm normalizes with the batch's statistics: the mean and the
biased variance over (N, H, W) in float32, eps 1e-3, applied as ``y *
scale + (beta - mean * scale)`` (``lpr_tpu/models/yolo.py:97-108``); the
running statistics move by momentum 0.03 toward the batch's mean and
biased variance (``:849-870``).  ``torch.nn.functional.batch_norm`` is not
used: its running variance takes the unbiased estimate.  BottleneckCSP's
standalone batch norm (eps 1e-5) keeps its running statistics in training,
as the JAX layer does.  Gradients reach the HWIO leaves through every
rearrangement, the S2D stem's weight included.  No kernel is on this
route.

Under a process group (``train_forward(..., group=)``) the statistics are
the global batch's, as JAX's sharded step computes them
(``lpr_tpu/models/yolo.py:102-103``): the per-channel sums and the count
are all-reduced, then the centred squares about the global mean (two
passes, as ``jnp.var``), each through
:func:`~lpr_tpu_torch.parallel.collectives.all_reduce_sum`, whose backward
all-reduces the gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from lpr_tpu_torch.models import yolo as Y
from lpr_tpu_torch.ops import nn as tnn

Tensor = torch.Tensor
BN_MOMENTUM = 0.03   # torch YOLO BatchNorm2d momentum
BN_EPS = tnn.BN_EPS
CSP_BN_EPS = 1e-5    # BottleneckCSP's standalone batch norm


def _hwio(w: Tensor) -> Tensor:
    return w.permute(3, 2, 0, 1)


class TrainPass:
    """One training forward: the flat state's tensors ``t`` and the batch
    statistics that each conv's batch norm took (``stats``, by conv key)."""

    def __init__(self, tensors: Dict[str, Tensor], group=None):
        self.t = tensors
        self.group = group
        self.stats: Dict[str, Tuple[Tensor, Tensor]] = {}

    def batch_stats(self, y32: Tensor) -> Tuple[Tensor, Tensor]:
        """The mean and biased variance over (N, H, W): this batch's, or
        under a process group the global batch's."""
        if self.group is None:
            return (y32.mean(dim=(0, 1, 2)),
                    y32.var(dim=(0, 1, 2), unbiased=False))
        from lpr_tpu_torch.parallel.collectives import all_reduce_sum

        n = y32.new_full((1,), y32.numel() // y32.shape[-1])
        sn = all_reduce_sum(torch.cat([y32.sum(dim=(0, 1, 2)), n]),
                            self.group)
        mean = sn[:-1] / sn[-1]
        d = y32 - mean
        var = all_reduce_sum((d * d).sum(dim=(0, 1, 2)),
                             self.group) / sn[-1]
        return mean, var

    def conv(self, key: str, x: Tensor, *, k: int, stride=1, pad=None,
             groups: int = 1, act: str = "silu",
             w: Optional[Tensor] = None) -> Tensor:
        """Conv(+batch norm on batch statistics)+activation, the JAX
        ``_conv`` under its training context."""
        w = self.t[f"{key}/w"] if w is None else w
        y = tnn.conv2d(x, _hwio(w), self.t.get(f"{key}/b"), stride=stride,
                       padding=k // 2 if pad is None else pad, groups=groups)
        if f"{key}/bn/gamma" in self.t:
            mean, var = self.batch_stats(y.float())
            self.stats[key] = (mean, var)
            scale = self.t[f"{key}/bn/gamma"] * torch.rsqrt(var + BN_EPS)
            y = y * scale.to(y.dtype) + (self.t[f"{key}/bn/beta"]
                                         - mean * scale).to(y.dtype)
        return tnn.act(y, act)

    def linear(self, x: Tensor, key: str, bias: Optional[str] = None):
        return tnn.linear(x, self.t[key],
                          None if bias is None else self.t[bias])

    def running_stats(self) -> Dict[str, Tensor]:
        """{``<key>/bn/mean``, ``<key>/bn/var``: the new running
        statistics}, without gradient: ``(1 - m) * old + m * batch``."""
        m = BN_MOMENTUM
        out = {}
        with torch.no_grad():
            for key, (mean, var) in self.stats.items():
                for name, batch in (("mean", mean), ("var", var)):
                    old = self.t[f"{key}/bn/{name}"]
                    out[f"{key}/bn/{name}"] = ((1 - m) * old.detach()
                                               + m * batch.detach())
        return out


# ---------------------------------------------------------------------------
# the layers' training forwards


def _bottleneck(tp: TrainPass, key: str, x: Tensor, shortcut: bool,
                g: int = 1) -> Tensor:
    y = tp.conv(f"{key}/cv2", tp.conv(f"{key}/cv1", x, k=1), k=3, groups=g)
    return x + y if shortcut else y


def _ghost_conv(tp: TrainPass, key: str, x: Tensor, c2: int, k: int = 1,
                s: int = 1, act: str = "silu") -> Tensor:
    c_ = c2 // 2
    y = tp.conv(f"{key}/cv1", x, k=k, stride=s, act=act)
    return torch.cat([y, tp.conv(f"{key}/cv2", y, k=5, groups=c_, act=act)],
                     -1)


def _ghost_bottleneck(tp: TrainPass, key: str, x: Tensor, c1: int, c2: int,
                      k: int = 3, s: int = 1) -> Tensor:
    c_ = c2 // 2
    y = _ghost_conv(tp, f"{key}/g1", x, c_)
    if s == 2:
        y = tp.conv(f"{key}/dw", y, k=k, stride=2, groups=c_, act="none")
    y = _ghost_conv(tp, f"{key}/g2", y, c2, act="none")
    if s == 2:
        sc = tp.conv(f"{key}/sc_dw", x, k=k, stride=2, groups=c1,
                     act="none")
        sc = tp.conv(f"{key}/sc_pw", sc, k=1, act="none")
    else:
        sc = x
    return y + sc


def _spp(tp: TrainPass, key: str, x: Tensor, ks) -> Tensor:
    y = tp.conv(f"{key}/cv1", x, k=1)
    pools = [tnn.max_pool2d(y, kk, 1, kk // 2) for kk in ks]
    return tp.conv(f"{key}/cv2", torch.cat([y] + pools, -1), k=1)


def _transformer(tp: TrainPass, key: str, x: Tensor, c: int, heads: int,
                 layers: int) -> Tensor:
    if f"{key}/conv/w" in tp.t:
        x = tp.conv(f"{key}/conv", x, k=1)
    B, H, W, C = x.shape
    t = x.reshape(B, H * W, C)
    t = t + tp.linear(t, f"{key}/linear/w", f"{key}/linear/b")
    dk = c // heads
    for j in range(layers):
        p = f"{key}/tr/{j}"
        w, b = tp.t[f"{p}/in_proj_w"], tp.t[f"{p}/in_proj_b"]
        q = tnn.linear(tp.linear(t, f"{p}/q"), w[:, :c], b[:c])
        k = tnn.linear(tp.linear(t, f"{p}/k"), w[:, c:2 * c], b[c:2 * c])
        v = tnn.linear(tp.linear(t, f"{p}/v"), w[:, 2 * c:], b[2 * c:])
        L = q.shape[1]
        q = q.reshape(B, L, heads, dk).transpose(1, 2) / math.sqrt(dk)
        k = k.reshape(B, L, heads, dk).transpose(1, 2)
        v = v.reshape(B, L, heads, dk).transpose(1, 2)
        att = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        out = (att @ v).transpose(1, 2).reshape(B, L, c)
        t = tp.linear(out, f"{p}/out_proj_w", f"{p}/out_proj_b") + t
        t = tp.linear(tp.linear(t, f"{p}/fc1"), f"{p}/fc2") + t
    return t.reshape(B, H, W, C)


def _c3_inner(lay, tp: TrainPass, key: str, y: Tensor) -> Tensor:
    c_ = int(lay.c2 * lay.e)
    if isinstance(lay, Y.C3TR):
        return _transformer(tp, f"{key}/m", y, c_, 4, lay.n)
    if isinstance(lay, Y.C3SPP):
        return _spp(tp, f"{key}/m", y, lay.k)
    for j in range(lay.n):
        if isinstance(lay, Y.C3Ghost):
            y = _ghost_bottleneck(tp, f"{key}/m/{j}", y, c_, c_)
        else:
            y = _bottleneck(tp, f"{key}/m/{j}", y, lay.shortcut, lay.g)
    return y


def _s2d_stem_weight(w: Tensor) -> Tensor:
    """(6, 6, c1, c2) -> (3, 3, 4 c1, c2) in torch, so the gradient
    reaches the 6x6 leaf (``tnn.s2d_stem_weight``'s rearrangement)."""
    c1, c2 = w.shape[2], w.shape[3]
    return (w.reshape(3, 2, 3, 2, c1, c2).permute(0, 2, 4, 1, 3, 5)
            .reshape(3, 3, c1 * 4, c2))


def layer_train(lay, tp: TrainPass, x, key: str):
    """One layer of the plan in training mode (its flat state under
    ``key``)."""
    if isinstance(lay, Y.Conv):                       # DWConv too
        if lay._is_s2d_stem():
            w = _s2d_stem_weight(tp.t[f"{key}/w"])
            return tp.conv(key, tnn.pixel_unshuffle(x, 2), k=3, stride=1,
                           pad=1, act=lay.act, w=w)
        return tp.conv(key, x, k=lay.k, stride=lay.s, pad=lay.pad,
                       groups=lay.g, act=lay.act)
    if isinstance(lay, Y.Focus):
        return tp.conv(key, tnn.space_to_depth_focus(x), k=lay.k,
                       stride=lay.s)
    if isinstance(lay, Y.C3):
        y1 = _c3_inner(lay, tp, key, tp.conv(f"{key}/cv1", x, k=1))
        y2 = tp.conv(f"{key}/cv2", x, k=1)
        return tp.conv(f"{key}/cv3", torch.cat([y1, y2], -1), k=1)
    if isinstance(lay, Y.BottleneckLayer):
        return _bottleneck(tp, key, x, lay.shortcut and lay.c1 == lay.c2,
                           lay.g)
    if isinstance(lay, Y.BottleneckCSP):
        y = tp.conv(f"{key}/cv1", x, k=1)
        for j in range(lay.n):
            y = _bottleneck(tp, f"{key}/m/{j}", y, lay.shortcut, lay.g)
        y1 = tnn.conv2d(y, _hwio(tp.t[f"{key}/cv3/w"]), padding=0)
        y2 = tnn.conv2d(x, _hwio(tp.t[f"{key}/cv2/w"]), padding=0)
        cat = torch.cat([y1, y2], -1)
        bn = {n: tp.t[f"{key}/bn/{n}"] for n in ("gamma", "beta", "mean",
                                                 "var")}
        scale = bn["gamma"] * torch.rsqrt(bn["var"] + CSP_BN_EPS)
        cat = cat * scale + (bn["beta"] - bn["mean"] * scale)
        return tp.conv(f"{key}/cv4", tnn.silu(cat), k=1)
    if isinstance(lay, Y.SPPF):
        y = tp.conv(f"{key}/cv1", x, k=1)
        y1 = tnn.max_pool2d(y, lay.k, 1, lay.k // 2)
        y2 = tnn.max_pool2d(y1, lay.k, 1, lay.k // 2)
        y3 = tnn.max_pool2d(y2, lay.k, 1, lay.k // 2)
        return tp.conv(f"{key}/cv2", torch.cat([y, y1, y2, y3], -1), k=1)
    if isinstance(lay, Y.SPP):
        return _spp(tp, key, x, lay.k)
    if isinstance(lay, Y.GhostConv):
        return _ghost_conv(tp, key, x, lay.c2, lay.k, lay.s, lay.act)
    if isinstance(lay, Y.GhostBottleneck):
        return _ghost_bottleneck(tp, key, x, lay.c1, lay.c2, lay.k, lay.s)
    if isinstance(lay, Y.Classify):
        x = (torch.cat([tnn.global_avg_pool(xi) for xi in x], -1)
             if isinstance(x, (list, tuple)) else tnn.global_avg_pool(x))
        y = tnn.conv2d(x[:, None, None, :], _hwio(tp.t[f"{key}/w"]),
                       tp.t.get(f"{key}/b"), stride=lay.s, padding=0)
        return y.reshape(y.shape[0], -1)
    if isinstance(lay, Y.Detect):
        xs = x if isinstance(x, (list, tuple)) else [x]
        raws = []
        for l, xl in enumerate(xs):
            y = tnn.conv2d(xl, _hwio(tp.t[f"{key}/m/{l}/w"]),
                           tp.t[f"{key}/m/{l}/b"], padding=0)
            B, ny, nx, _ = y.shape
            raws.append(y.reshape(B, ny, nx, lay.na, lay.no)
                        .permute(0, 3, 1, 2, 4))
        return raws
    return lay(x)          # Upsample, Concat, Contract, Expand: no weights


def train_forward(model: "Y.YoloModel", tensors: Dict[str, Tensor],
                  x: Tensor, group=None
                  ) -> Tuple[Union[List[Tensor], Tensor], Dict[str, Tensor]]:
    """``YoloModel.apply(params, x, decode=False, train=True)``: the raw
    Detect logits per level, (B, na, ny, nx, 5+nc), and the new running
    statistics ({``<key>/bn/mean|var``: tensor}, no gradient) of every
    conv's batch norm.  ``group``: batch statistics over every rank's
    ``x`` (each rank runs this with its own)."""
    tp = TrainPass(tensors, group)
    saved: Dict[int, object] = {}
    n = len(model.layers)
    y = x
    for lay in model.layers:
        if lay.f != -1:
            if isinstance(lay.f, int):
                y = saved[lay.f % n]
            else:
                y = [y if j == -1 else saved[j % n] for j in lay.f]
        y = layer_train(lay, tp, y, str(lay.i))
        if lay.i in model.save:
            saved[lay.i] = y
    return y, tp.running_stats()


# ---------------------------------------------------------------------------
# fresh weights


class _Init:
    """Draws JAX's distributions from a ``torch.Generator``: every conv
    and Linear weight (and bias, where a layer has one) uniform in
    +-sqrt(1 / fan_in), batch norm gamma 1, beta 0, mean 0, var 1, the
    attention's projection biases 0.  The values are not JAX's."""

    def __init__(self, g: torch.Generator):
        self.g = g
        self.out: Dict[str, np.ndarray] = {}

    def uniform(self, shape, bound: float) -> np.ndarray:
        u = torch.rand(shape, generator=self.g, device=self.g.device)
        return ((u * 2.0 - 1.0) * bound).cpu().numpy()

    def bn(self, key: str, c: int) -> None:
        self.out[f"{key}/gamma"] = np.ones((c,), np.float32)
        self.out[f"{key}/beta"] = np.zeros((c,), np.float32)
        self.out[f"{key}/mean"] = np.zeros((c,), np.float32)
        self.out[f"{key}/var"] = np.ones((c,), np.float32)

    def conv(self, key: str, k: int, c1: int, c2: int, groups: int = 1,
             bias: bool = False, bn: bool = True) -> None:
        bound = float(np.sqrt(1.0 / max(c1 // groups * k * k, 1)))
        self.out[f"{key}/w"] = self.uniform((k, k, c1 // groups, c2), bound)
        if bias:
            self.out[f"{key}/b"] = self.uniform((c2,), bound)
        if bn:
            self.bn(f"{key}/bn", c2)

    def bottleneck(self, key, c1, c2, g=1, e=0.5):
        c_ = int(c2 * e)
        self.conv(f"{key}/cv1", 1, c1, c_)
        self.conv(f"{key}/cv2", 3, c_, c2, g)

    def ghost_conv(self, key, c1, c2, k=1):
        c_ = c2 // 2
        self.conv(f"{key}/cv1", k, c1, c_)
        self.conv(f"{key}/cv2", 5, c_, c_, groups=c_)

    def ghost_bottleneck(self, key, c1, c2, k=3, s=1):
        c_ = c2 // 2
        self.ghost_conv(f"{key}/g1", c1, c_)
        self.ghost_conv(f"{key}/g2", c_, c2)
        if s == 2:
            self.conv(f"{key}/dw", k, c_, c_, groups=c_)
            self.conv(f"{key}/sc_dw", k, c1, c1, groups=c1)
            self.conv(f"{key}/sc_pw", 1, c1, c2)

    def spp(self, key, c1, c2, nk):
        c_ = c1 // 2
        self.conv(f"{key}/cv1", 1, c1, c_)
        self.conv(f"{key}/cv2", 1, c_ * (nk + 1), c2)

    def transformer(self, key, c1, c, layers):
        if c1 != c:
            self.conv(f"{key}/conv", 1, c1, c)
        bound = float(np.sqrt(1.0 / c))
        self.out[f"{key}/linear/w"] = self.uniform((c, c), bound)
        self.out[f"{key}/linear/b"] = self.uniform((c,), bound)
        for j in range(layers):
            p = f"{key}/tr/{j}"
            for name, shape in (("q", (c, c)), ("k", (c, c)), ("v", (c, c)),
                                ("in_proj_w", (c, 3 * c)),
                                ("out_proj_w", (c, c)), ("fc1", (c, c)),
                                ("fc2", (c, c))):
                self.out[f"{p}/{name}"] = self.uniform(shape, bound)
            self.out[f"{p}/in_proj_b"] = np.zeros((3 * c,), np.float32)
            self.out[f"{p}/out_proj_b"] = np.zeros((c,), np.float32)

    def layer(self, lay, key: str) -> None:
        if isinstance(lay, Y.Conv):
            self.conv(key, lay.k, lay.c1, lay.c2, lay.g)
        elif isinstance(lay, Y.Focus):
            self.conv(key, lay.k, lay.c1 * 4, lay.c2)
        elif isinstance(lay, Y.C3):
            c_ = int(lay.c2 * lay.e)
            self.conv(f"{key}/cv1", 1, lay.c1, c_)
            self.conv(f"{key}/cv2", 1, lay.c1, c_)
            self.conv(f"{key}/cv3", 1, 2 * c_, lay.c2)
            if isinstance(lay, Y.C3TR):
                self.transformer(f"{key}/m", c_, c_, lay.n)
            elif isinstance(lay, Y.C3SPP):
                self.spp(f"{key}/m", c_, c_, len(lay.k))
            else:
                for j in range(lay.n):
                    if isinstance(lay, Y.C3Ghost):
                        self.ghost_bottleneck(f"{key}/m/{j}", c_, c_)
                    else:
                        self.bottleneck(f"{key}/m/{j}", c_, c_, lay.g, 1.0)
        elif isinstance(lay, Y.BottleneckLayer):
            self.bottleneck(key, lay.c1, lay.c2, lay.g)
        elif isinstance(lay, Y.BottleneckCSP):
            c_ = int(lay.c2 * lay.e)
            self.conv(f"{key}/cv1", 1, lay.c1, c_)
            self.conv(f"{key}/cv2", 1, lay.c1, c_, bn=False)
            self.conv(f"{key}/cv3", 1, c_, c_, bn=False)
            self.conv(f"{key}/cv4", 1, 2 * c_, lay.c2)
            self.bn(f"{key}/bn", 2 * c_)
            for j in range(lay.n):
                self.bottleneck(f"{key}/m/{j}", c_, c_, lay.g, 1.0)
        elif isinstance(lay, Y.SPPF):
            self.spp(key, lay.c1, lay.c2, 3)
        elif isinstance(lay, Y.SPP):
            self.spp(key, lay.c1, lay.c2, len(lay.k))
        elif isinstance(lay, Y.GhostConv):
            self.ghost_conv(key, lay.c1, lay.c2, lay.k)
        elif isinstance(lay, Y.GhostBottleneck):
            self.ghost_bottleneck(key, lay.c1, lay.c2, lay.k, lay.s)
        elif isinstance(lay, Y.Classify):
            self.conv(key, lay.k, lay.c1, lay.c2, bias=True, bn=False)
        elif isinstance(lay, Y.Detect):
            for l in range(lay.nl):
                self.conv(f"{key}/m/{l}", 1, lay.ch[l], lay.na * lay.no,
                          bias=True, bn=False)


def yolo_init(spec: Union["Y.YoloSpec", "Y.YoloModel"],
              g: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
    """Fresh weights of a detector as the flat unfolded state (numpy
    float32), with the JAX package's distributions (``_init_conv`` and each
    layer's ``init``, ``lpr_tpu/models/yolo.py:54-68``), drawn from ``g``
    (default: a CPU generator seeded 0).  ``spec`` is a :class:`YoloSpec`
    or a built :class:`YoloModel`."""
    model = spec if isinstance(spec, Y.YoloModel) else Y.build_yolo(
        spec, strides=_default_strides(spec))
    init = _Init(torch.Generator().manual_seed(0) if g is None else g)
    for lay in model.layers:
        init.layer(lay, str(lay.i))
    return init.out


def _default_strides(spec: "Y.YoloSpec") -> Tuple[int, ...]:
    nl = len(spec.head[-1][0]) if isinstance(spec.head[-1][0], list) else 1
    return tuple(8 * 2 ** i for i in range(nl))
