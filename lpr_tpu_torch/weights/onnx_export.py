"""Dependency-free ONNX emitter for LPSR and the YOLO detectors
(counterpart of ``lpr_tpu/weights/onnx_export.py``), numpy and ``struct``
only.

The reference exports its models to ONNX with dynamic axes for Triton
serving (``my_utils/export_onnx.py:38-99``: LPSR with input
``input_image`` and output ``output_image``, opset 16, dynamic
batch/height/width; the detection and OCR models with ``input_image`` ->
``predictions``, decode included, NMS excluded, dynamic batch).  No onnx
package is needed: this module writes the protobuf wire format directly
(field numbers per the public onnx.proto schema), with initializers under
the reference's torch state-dict names, so :mod:`lpr_tpu_torch.weights
.onnx_import` and onnxruntime both read the artifact.

The emitters take the port's layer plan (:class:`~lpr_tpu_torch.models
.yolo.YoloModel` or :class:`~lpr_tpu_torch.models.lpsr.LPSRConfig`) and the
flat float32 state (:mod:`lpr_tpu_torch.weights.checkpoint`), not the
modules' tensors: the modules hold batch norm folded and the v6 stem as
its space-to-depth 3x3 rearrangement, while the graph keeps the plain
k6/s2 stem and folds a state's ``bn/*`` at emit time, so that the bytes
equal the JAX emitter's for the same weights.

Graph notes (as torch.onnx emits the same models):

- the mult-of-4 AutoEncoder pad is dynamic: Shape -> Gather -> Mod -> Pad;
- PixelUnshuffle is a Reshape/Transpose/Reshape chain with shape math (ONNX
  SpaceToDepth has the wrong channel order for torch semantics);
- PixelShuffle is DepthToSpace mode="CRD" (exactly torch's order);
- the shared CSAR appears twice in the node list but references one set of
  ``rdn.csar.*`` initializers.
"""

from __future__ import annotations

import struct
from typing import Any, List, Mapping, Optional, Sequence, Union

import numpy as np

# --------------------------------------------------------------------------
# protobuf wire-format writers

_F32, _I64 = 1, 7  # onnx TensorProto.DataType


def _vint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _f_msg(num: int, payload: bytes) -> bytes:
    """Length-delimited field (messages, strings, bytes, packed)."""
    return _vint((num << 3) | 2) + _vint(len(payload)) + payload


def _f_str(num: int, s: str) -> bytes:
    return _f_msg(num, s.encode("utf-8"))


def _f_int(num: int, v: int) -> bytes:
    return _vint((num << 3) | 0) + _vint(v)


def _tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, int64_data=7, name=8, raw_data=9."""
    arr = np.asarray(arr)
    if arr.dtype == np.int64:
        dt, raw = _I64, arr.astype("<i8").tobytes()
    else:
        dt, raw = _F32, arr.astype("<f4").tobytes()
    out = b"".join(_f_int(1, int(d)) for d in arr.shape)
    out += _f_int(2, dt)
    out += _f_str(8, name)
    out += _f_msg(9, raw)
    return out


def _attr(name: str, *, i: Optional[int] = None, f: Optional[float] = None,
          s: Optional[str] = None,
          ints: Optional[Sequence[int]] = None) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, ints=8, type=20."""
    out = _f_str(1, name)
    if i is not None:
        out += _f_int(3, int(i)) + _f_int(20, 2)            # INT
    elif f is not None:
        out += _vint((2 << 3) | 5) + struct.pack("<f", f) + _f_int(20, 1)
    elif s is not None:
        out += _f_msg(4, s.encode("utf-8")) + _f_int(20, 3)  # STRING
    elif ints is not None:
        out += b"".join(_f_int(8, int(v)) for v in ints) + _f_int(20, 7)
    return out


def _node(op: str, inputs: Sequence[str], outputs: Sequence[str],
          name: str = "", attrs: Sequence[bytes] = ()) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b"".join(_f_str(1, x) for x in inputs)
    out += b"".join(_f_str(2, x) for x in outputs)
    if name:
        out += _f_str(3, name)
    out += _f_str(4, op)
    out += b"".join(_f_msg(5, a) for a in attrs)
    return out


def _value_info(name: str, dims: Sequence[Union[int, str]],
                elem_type: int = _F32) -> bytes:
    """ValueInfoProto(name=1, type=2) / TypeProto.tensor_type=1 /
    Tensor(elem_type=1, shape=2) / TensorShapeProto.dim=1 /
    Dimension(dim_value=1, dim_param=2)."""
    dim_msgs = b"".join(
        _f_msg(1, _f_int(1, d) if isinstance(d, int) else _f_str(2, d))
        for d in dims
    )
    tensor = _f_int(1, elem_type) + _f_msg(2, dim_msgs)
    return _f_str(1, name) + _f_msg(2, _f_msg(1, tensor))


class OnnxGraph:
    """Tiny graph builder: add nodes/initializers, serialize a ModelProto."""

    def __init__(self, name: str = "lpr_tpu"):
        self.name = name
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self._init_names: set = set()
        self._n = 0

    # -- construction ------------------------------------------------------
    def fresh(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init_tensor(self, name: str, arr: np.ndarray) -> str:
        if name not in self._init_names:  # shared weights emit once
            self._init_names.add(name)
            self.inits.append(_tensor(name, arr))
        return name

    def const_i64(self, values: Sequence[int], name: Optional[str] = None
                  ) -> str:
        name = name or self.fresh("ci64")
        return self.init_tensor(name, np.asarray(values, np.int64))

    def op(self, op: str, inputs: Sequence[str], n_out: int = 1,
           attrs: Sequence[bytes] = (), out: Optional[str] = None):
        outs = [out or self.fresh(op.lower())] if n_out == 1 else [
            self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append(_node(op, inputs, outs,
                                name=self.fresh(f"n_{op}"), attrs=attrs))
        return outs[0] if n_out == 1 else outs

    # -- serialization -----------------------------------------------------
    def serialize(self, inputs: Sequence[bytes], outputs: Sequence[bytes],
                  opset: int = 16, ir_version: int = 8,
                  producer: str = "lpr_tpu") -> bytes:
        """GraphProto: node=1, name=2, initializer=5, input=11, output=12.
        ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8."""
        g = b"".join(_f_msg(1, n) for n in self.nodes)
        g += _f_str(2, self.name)
        g += b"".join(_f_msg(5, t) for t in self.inits)
        g += b"".join(_f_msg(11, v) for v in inputs)
        g += b"".join(_f_msg(12, v) for v in outputs)
        model = _f_int(1, ir_version)
        model += _f_str(2, producer)
        model += _f_msg(7, g)
        model += _f_msg(8, _f_str(1, "") + _f_int(2, opset))
        return model


class _Tree:
    """Read-only nested view of a flat state: ``t["rdn"]["rdbs"][0]["w"]``
    is the entry ``rdn/rdbs/0/w``; a key that is a prefix of entries gives
    the view under it."""

    def __init__(self, state: Mapping[str, np.ndarray], prefix: str = "",
                 _dirs: Optional[set] = None):
        self.state = state
        self.prefix = prefix
        if _dirs is None:
            _dirs = {k[:i] for k in state for i, ch in enumerate(k)
                     if ch == "/"}
        self._dirs = _dirs

    def __getitem__(self, key) -> Any:
        k = f"{self.prefix}{key}"
        if k in self.state:
            return self.state[k]
        if k not in self._dirs:
            raise KeyError(k)
        return _Tree(self.state, k + "/", self._dirs)

    def __contains__(self, key) -> bool:
        k = f"{self.prefix}{key}"
        return k in self.state or k in self._dirs

    def get(self, key, default=None):
        return self[key] if key in self else default


# --------------------------------------------------------------------------
# LPSR graph


def _to_oihw(w) -> np.ndarray:
    return np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))


class _LpsrEmitter:
    def __init__(self, state: Mapping[str, np.ndarray], cfg):
        self.g = OnnxGraph("lpsr")
        self.p = _Tree(state)
        self.cfg = cfg

    # conv with torch-named weights; p = {"w": HWIO, "b"?}
    def conv(self, x: str, name: str, p, k: int, groups: int = 1,
             dw: bool = False) -> str:
        g = self.g
        w = np.asarray(p["w"], np.float32)
        if dw:
            # the depthwise layout (k, k, 1, C) -> torch (C, 1, k, k)
            w_t = np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))
        else:
            w_t = _to_oihw(w)
        ins = [x, g.init_tensor(f"{name}.weight", w_t)]
        if "b" in p:
            ins.append(g.init_tensor(f"{name}.bias",
                                     np.asarray(p["b"], np.float32)))
        pad = k // 2
        return g.op("Conv", ins, attrs=[
            _attr("dilations", ints=[1, 1]),
            _attr("group", i=groups),
            _attr("kernel_shape", ints=[k, k]),
            _attr("pads", ints=[pad, pad, pad, pad]),
            _attr("strides", ints=[1, 1]),
        ])

    def dconv(self, x: str, name: str, p, cin: int) -> str:
        y = self.conv(x, f"{name}.dConv.0", p["dw"], self.cfg.ae_kernel,
                      groups=cin, dw=True)
        return self.conv(y, f"{name}.dConv.1", p["pw"], 1)

    def pixel_unshuffle(self, x: str, r: int = 2) -> str:
        """torch PixelUnshuffle: (N,C,H,W)->(N,C*r^2,H/r,W/r), C-major
        channel order — Reshape/Transpose/Reshape with dynamic shape math."""
        g = self.g
        shape = g.op("Shape", [x])
        n = g.op("Gather", [shape, g.const_i64([0])], attrs=[_attr("axis", i=0)])
        c = g.op("Gather", [shape, g.const_i64([1])], attrs=[_attr("axis", i=0)])
        h = g.op("Gather", [shape, g.const_i64([2])], attrs=[_attr("axis", i=0)])
        w = g.op("Gather", [shape, g.const_i64([3])], attrs=[_attr("axis", i=0)])
        rr = g.const_i64([r])
        h2 = g.op("Div", [h, rr])
        w2 = g.op("Div", [w, rr])
        tgt1 = g.op("Concat", [n, c, h2, rr, w2, rr], attrs=[_attr("axis", i=0)])
        y = g.op("Reshape", [x, tgt1])
        y = g.op("Transpose", [y], attrs=[_attr("perm", ints=[0, 1, 3, 5, 2, 4])])
        c4 = g.op("Mul", [c, g.const_i64([r * r])])
        tgt2 = g.op("Concat", [n, c4, h2, w2], attrs=[_attr("axis", i=0)])
        return g.op("Reshape", [y, tgt2])

    def pixel_shuffle(self, x: str, r: int = 2) -> str:
        return self.g.op("DepthToSpace", [x], attrs=[
            _attr("blocksize", i=r), _attr("mode", s="CRD")])

    # -- blocks -------------------------------------------------------------
    def autoencoder(self, x: str) -> str:
        g, cfg = self.g, self.cfg
        ap = self.p["auto_encoder"]
        e = cfg.expansion * cfg.num_channels
        # dynamic pad of H, W up to multiples of 4
        shape = g.op("Shape", [x])
        hw = g.op("Gather", [shape, g.const_i64([2, 3])],
                  attrs=[_attr("axis", i=0)])
        four = g.const_i64([4, 4])
        rem = g.op("Mod", [hw, four])
        pad_amt = g.op("Mod", [g.op("Sub", [four, rem]), four])
        pads = g.op("Concat", [g.const_i64([0] * 6), pad_amt],
                    attrs=[_attr("axis", i=0)])
        xp = g.op("Pad", [x, pads])
        conv_in = self.conv(xp, "auto_encoder.conv_in", ap["conv_in"], 3)
        y = self.dconv(conv_in, "auto_encoder.encoder.0", ap["enc0"], e)
        y = g.op("Relu", [self.pixel_unshuffle(y)])
        y = self.dconv(y, "auto_encoder.encoder.3", ap["enc1"], e * 4)
        y = g.op("Relu", [self.pixel_unshuffle(y)])
        y = self.dconv(y, "auto_encoder.decoder.0", ap["dec0"], e * 4)
        y = g.op("Relu", [self.pixel_shuffle(y)])
        y = self.dconv(y, "auto_encoder.decoder.3", ap["dec1"], e)
        y = g.op("Relu", [self.pixel_shuffle(y)])
        out = g.op("Add", [conv_in, y])
        return self.conv(out, "auto_encoder.conv_out", ap["conv_out"], 3)

    def rdb(self, x: str, name: str, p) -> str:
        g = self.g
        y = x
        for i in range(self.cfg.num_layers):
            c = g.op("Relu", [self.conv(y, f"{name}.layers.{i}.conv",
                                        p["layers"][i], 3)])
            y = g.op("Concat", [y, c], attrs=[_attr("axis", i=1)])
        lff = self.conv(y, f"{name}.lff", p["lff"], 1)
        alpha = g.init_tensor(f"{name}.alpha",
                              np.asarray(p["alpha"], np.float32).reshape(()))
        return g.op("Add", [x, g.op("Mul", [lff, alpha])])

    def gemm(self, x: str, name: str, p) -> str:
        g = self.g
        w = g.init_tensor(f"{name}.weight",
                          np.ascontiguousarray(np.asarray(p["w"], np.float32).T))
        b = g.init_tensor(f"{name}.bias", np.asarray(p["b"], np.float32))
        return g.op("Gemm", [x, w, b], attrs=[
            _attr("alpha", f=1.0), _attr("beta", f=1.0),
            _attr("transB", i=1)])

    def csar(self, x: str, p) -> str:
        g = self.g
        name = "rdn.csar"
        x_in = self.conv(
            g.op("Relu", [self.conv(x, f"{name}.conv_in.0", p["conv_in0"], 3)]),
            f"{name}.conv_in.2", p["conv_in1"], 3)
        # channel attention (note the reference's x_in^2 * mask quirk)
        ca = g.op("Flatten", [g.op("GlobalAveragePool", [x_in])],
                  attrs=[_attr("axis", i=1)])
        ca = self.gemm(ca, f"{name}.ca.block.2", p["ca_fc1"])
        ca = self.gemm(g.op("Relu", [ca]), f"{name}.ca.block.4", p["ca_fc2"])
        ca = g.op("Sigmoid", [ca])
        ca = g.op("Unsqueeze", [ca, g.const_i64([2, 3])])
        x_ca = g.op("Mul", [x_in, ca])
        sa = g.op("Relu", [self.conv(x_in, f"{name}.sa.block.0",
                                     p["sa_conv1"], 1)])
        sa = g.op("Sigmoid", [self.conv(sa, f"{name}.sa.block.2",
                                        p["sa_conv2"], 1)])
        y = g.op("Concat", [g.op("Mul", [x_in, x_ca]),
                            g.op("Mul", [x_in, sa])],
                 attrs=[_attr("axis", i=1)])
        return g.op("Add", [x, self.conv(y, f"{name}.conv_out",
                                         p["conv_out"], 1)])

    def build(self) -> bytes:
        g, cfg = self.g, self.cfg
        x = "input_image"
        y = self.autoencoder(x)
        r = self.p["rdn"]
        sfe1 = self.conv(y, "rdn.shallowF1", r["shallowF1"], 7)
        sfe2 = self.conv(sfe1, "rdn.shallowF2", r["shallowF2"], 3)
        y = sfe2
        local_features = []
        for i in range(cfg.num_blocks):
            if i % 2 == 0:
                y = self.rdb(y, f"rdn.rdbs.{2 * (i // 2)}",
                             r["rdbs"][i // 2])
            else:
                y = self.csar(y, r["csar"])
            local_features.append(y)
        y = g.op("Concat", local_features, attrs=[_attr("axis", i=1)])
        y = self.conv(y, "rdn.gff.0", r["gff0"], 1)
        y = g.op("Add", [self.conv(y, "rdn.gff.1", r["gff1"], 3), sfe1])
        y = self.conv(y, "final_conv", self.p["final_conv"], 3)
        g.op("Sigmoid", [y], out="output_image")
        # dynamic axes exactly as the reference exporter names them
        vin = _value_info("input_image",
                          ["batch_size", cfg.num_channels, "height", "width"])
        vout = _value_info("output_image",
                           ["batch_size", cfg.out_channels, "height", "width"])
        return g.serialize([vin], [vout], opset=16)


# --------------------------------------------------------------------------
# YOLO detector graph (decode included, NMS excluded — the reference's
# export surface for the detection/ocr models, my_utils/export_onnx.py:66-99:
# input "input_image" (B,3,H,W), output "predictions" (B,N,5+nc), opset 16,
# dynamic batch only)


class _YoloEmitter:
    """Walk a :class:`lpr_tpu_torch.models.yolo.YoloModel` layer plan and
    emit the equivalent ONNX graph at a fixed spatial size (dynamic batch).

    Covers the layers the two reference detectors use: Conv (incl. the v6
    stem, emitted as its plain k6/s2 torch form), DWConv, Focus,
    Bottleneck, C3, C3TR (transformer block), SPP, SPPF, Upsample, Concat,
    Detect with fused decode.  A conv's state holds ``w`` (and ``b``) or
    carries ``bn/*``, which is folded at emit time.
    """

    def __init__(self, model, state: Mapping[str, np.ndarray], hw):
        self.g = OnnxGraph("yolo")
        self.model = model
        self.params = _Tree(state)
        self.hw = tuple(hw)

    # -- primitives --------------------------------------------------------
    def conv(self, x, name, p, k, s=1, pad=None, groups=1, act="silu"):
        g = self.g
        w = np.asarray(p["w"], np.float32)
        b = p.get("b")
        if "bn" in p:
            from lpr_tpu_torch.ops import nn as tnn

            bn = p["bn"]
            w, b = tnn.fuse_conv_bn(w, b, bn["gamma"], bn["beta"],
                                    bn["mean"], bn["var"])
        ins = [x, g.init_tensor(f"{name}.weight", _to_oihw(w))]
        if b is not None:
            ins.append(g.init_tensor(f"{name}.bias", np.asarray(b, np.float32)))
        pd = k // 2 if pad is None else pad
        y = g.op("Conv", ins, attrs=[
            _attr("dilations", ints=[1, 1]),
            _attr("group", i=groups),
            _attr("kernel_shape", ints=[k, k]),
            _attr("pads", ints=[pd, pd, pd, pd]),
            _attr("strides", ints=[s, s]),
        ])
        if act == "silu":
            y = g.op("Mul", [y, g.op("Sigmoid", [y])])
        elif act == "leaky":
            y = g.op("LeakyRelu", [y], attrs=[_attr("alpha", f=0.1)])
        return y

    def sconst(self, v):
        return self.g.init_tensor(self.g.fresh("c"),
                                  np.asarray(v, np.float32))

    def linear(self, x, name, w, b=None):
        """(B, L, Cin) @ (Cin, Cout) [+ b]."""
        g = self.g
        y = g.op("MatMul", [x, g.init_tensor(f"{name}.weight",
                                             np.asarray(w, np.float32))])
        if b is not None:
            y = g.op("Add", [y, g.init_tensor(f"{name}.bias",
                                              np.asarray(b, np.float32))])
        return y

    def reshape(self, x, dims):
        return self.g.op("Reshape", [x, self.g.const_i64(dims)])

    def transpose(self, x, perm):
        return self.g.op("Transpose", [x], attrs=[_attr("perm", ints=perm)])

    # -- blocks ------------------------------------------------------------
    def bottleneck(self, x, name, p, lay_c1, lay_c2, shortcut, g_=1):
        y = self.conv(x, f"{name}.cv1", p["cv1"], 1)
        y = self.conv(y, f"{name}.cv2", p["cv2"], 3, groups=g_)
        if shortcut and lay_c1 == lay_c2:
            y = self.g.op("Add", [x, y])
        return y

    def c3(self, x, name, p, lay):
        y1 = self.conv(x, f"{name}.cv1", p["cv1"], 1)
        c_ = int(lay.c2 * lay.e)
        for j in range(lay.n):
            y1 = self.bottleneck(y1, f"{name}.m.{j}", p["m"][j], c_, c_,
                                 lay.shortcut, lay.g)
        y2 = self.conv(x, f"{name}.cv2", p["cv2"], 1)
        y = self.g.op("Concat", [y1, y2], attrs=[_attr("axis", i=1)])
        return self.conv(y, f"{name}.cv3", p["cv3"], 1)

    def transformer(self, x, name, p, c, nh, n_layers, h, w):
        """TransformerBlockL on an NCHW map (tokens = row-major H*W)."""
        g = self.g
        dk = c // nh
        L = h * w
        if "conv" in p:
            x = self.conv(x, f"{name}.conv", p["conv"], 1)
        t = self.transpose(self.reshape(x, [0, c, L]), [0, 2, 1])  # (B,L,C)
        pos = self.linear(t, f"{name}.linear", p["linear"]["w"],
                          p["linear"]["b"])
        t = g.op("Add", [t, pos])
        for j in range(n_layers):
            lp = p["tr"][j]
            q = self.linear(t, f"{name}.tr.{j}.q", lp["q"])
            k = self.linear(t, f"{name}.tr.{j}.k", lp["k"])
            v = self.linear(t, f"{name}.tr.{j}.v", lp["v"])
            ipw = np.asarray(lp["in_proj_w"], np.float32)
            ipb = np.asarray(lp["in_proj_b"], np.float32)
            q = self.linear(q, f"{name}.tr.{j}.ipq", ipw[:, :c], ipb[:c])
            k = self.linear(k, f"{name}.tr.{j}.ipk", ipw[:, c:2 * c],
                            ipb[c:2 * c])
            v = self.linear(v, f"{name}.tr.{j}.ipv", ipw[:, 2 * c:],
                            ipb[2 * c:])

            def heads(z):
                return self.transpose(self.reshape(z, [0, L, nh, dk]),
                                      [0, 2, 1, 3])  # (B,h,L,dk)

            q = g.op("Mul", [heads(q), self.sconst(1.0 / np.sqrt(dk))])
            att = g.op("MatMul", [q, self.transpose(heads(k), [0, 1, 3, 2])])
            att = g.op("Softmax", [att], attrs=[_attr("axis", i=-1)])
            o = g.op("MatMul", [att, heads(v)])
            o = self.reshape(self.transpose(o, [0, 2, 1, 3]), [0, L, c])
            o = self.linear(o, f"{name}.tr.{j}.out_proj", lp["out_proj_w"],
                            lp["out_proj_b"])
            t = g.op("Add", [o, t])
            f = self.linear(self.linear(t, f"{name}.tr.{j}.fc1", lp["fc1"]),
                            f"{name}.tr.{j}.fc2", lp["fc2"])
            t = g.op("Add", [f, t])
        return self.reshape(self.transpose(t, [0, 2, 1]), [0, c, h, w])

    def maxpool(self, x, k):
        return self.g.op("MaxPool", [x], attrs=[
            _attr("kernel_shape", ints=[k, k]),
            _attr("pads", ints=[k // 2] * 4),
            _attr("strides", ints=[1, 1]),
        ])

    def detect(self, xs, name, p, lay, hws):
        g = self.g
        outs = []
        for l, (x, (h, w)) in enumerate(zip(xs, hws)):
            y = self.conv(x, f"{name}.m.{l}", p["m"][l], 1, act="none")
            y = self.reshape(y, [0, lay.na, lay.no, h, w])
            y = self.transpose(y, [0, 1, 3, 4, 2])       # (B,na,ny,nx,no)
            sig = g.op("Sigmoid", [y])
            imax = np.iinfo(np.int64).max
            xy = g.op("Slice", [sig, g.const_i64([0]), g.const_i64([2]),
                                g.const_i64([4])])
            wh = g.op("Slice", [sig, g.const_i64([2]), g.const_i64([4]),
                                g.const_i64([4])])
            rest = g.op("Slice", [sig, g.const_i64([4]), g.const_i64([imax]),
                                  g.const_i64([4])])
            s = float(lay.strides[l])
            gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                                 np.arange(w, dtype=np.float32), indexing="ij")
            grid = np.stack([gx, gy], -1)[None, None]    # (1,1,ny,nx,2)
            anc = (np.asarray(lay.anchors[l], np.float32) * s
                   ).reshape(1, lay.na, 1, 1, 2)         # px
            xy = g.op("Mul", [xy, self.sconst(2.0)])
            xy = g.op("Sub", [xy, self.sconst(0.5)])
            xy = g.op("Add", [xy, g.init_tensor(g.fresh("grid"), grid)])
            xy = g.op("Mul", [xy, self.sconst(s)])
            wh = g.op("Mul", [wh, self.sconst(2.0)])
            wh = g.op("Mul", [wh, wh])
            wh = g.op("Mul", [wh, g.init_tensor(g.fresh("anchor"), anc)])
            y = g.op("Concat", [xy, wh, rest], attrs=[_attr("axis", i=4)])
            outs.append(self.reshape(y, [0, lay.na * h * w, lay.no]))
        return g.op("Concat", outs, attrs=[_attr("axis", i=1)],
                    out="predictions")

    # -- plan walk ---------------------------------------------------------
    def build(self) -> bytes:
        from lpr_tpu_torch.models import yolo as Y

        g = self.g
        saved = {}          # layer index -> (tensor name, (c, h, w))
        cur = ("input_image", (3, *self.hw))
        nlayers = len(self.model.layers)
        for lay in self.model.layers:
            p = self.params.get(lay.i, {})
            name = f"model.{lay.i}"
            if lay.f != -1:
                if isinstance(lay.f, int):
                    cur = saved[lay.f % nlayers] if lay.f >= 0 else cur
                else:
                    cur = [cur if j == -1 else saved[j % nlayers]
                           for j in lay.f]
            if isinstance(lay, Y.Focus):
                x, (c, h, w) = cur
                imax = np.iinfo(np.int64).max
                parts = []
                for oh, ow in ((0, 0), (1, 0), (0, 1), (1, 1)):
                    parts.append(g.op("Slice", [
                        x, g.const_i64([oh, ow]), g.const_i64([imax, imax]),
                        g.const_i64([2, 3]), g.const_i64([2, 2])]))
                z = g.op("Concat", parts, attrs=[_attr("axis", i=1)])
                y = self.conv(z, f"{name}.conv", p, lay.k, lay.s)
                cur = (y, (lay.c2, h // 2 // lay.s, w // 2 // lay.s))
            elif isinstance(lay, Y.Conv):  # incl. DWConv
                x, (c, h, w) = cur
                pd = lay.k // 2 if lay.pad is None else lay.pad
                y = self.conv(x, f"{name}.conv", p, lay.k, lay.s, pd,
                              lay.g, lay.act)
                oh = (h + 2 * pd - lay.k) // lay.s + 1
                ow = (w + 2 * pd - lay.k) // lay.s + 1
                cur = (y, (lay.c2, oh, ow))
            elif isinstance(lay, Y.C3TR):
                x, (c, h, w) = cur
                y1 = self.conv(x, f"{name}.cv1", p["cv1"], 1)
                y1 = self.transformer(y1, f"{name}.m", p["m"],
                                      int(lay.c2 * lay.e), 4, lay.n, h, w)
                y2 = self.conv(x, f"{name}.cv2", p["cv2"], 1)
                y = g.op("Concat", [y1, y2], attrs=[_attr("axis", i=1)])
                y = self.conv(y, f"{name}.cv3", p["cv3"], 1)
                cur = (y, (lay.c2, h, w))
            elif isinstance(lay, Y.C3) and not isinstance(
                    lay, (Y.C3SPP, Y.C3Ghost)):
                x, (c, h, w) = cur
                cur = (self.c3(x, name, p, lay), (lay.c2, h, w))
            elif isinstance(lay, Y.BottleneckLayer):
                x, (c, h, w) = cur
                cur = (self.bottleneck(x, name, p, lay.c1, lay.c2,
                                       lay.shortcut, lay.g),
                       (lay.c2, h, w))
            elif isinstance(lay, Y.SPP):
                x, (c, h, w) = cur
                y = self.conv(x, f"{name}.cv1", p["cv1"], 1)
                pools = [self.maxpool(y, kk) for kk in lay.k]
                y = g.op("Concat", [y] + pools, attrs=[_attr("axis", i=1)])
                cur = (self.conv(y, f"{name}.cv2", p["cv2"], 1),
                       (lay.c2, h, w))
            elif isinstance(lay, Y.SPPF):
                x, (c, h, w) = cur
                y = self.conv(x, f"{name}.cv1", p["cv1"], 1)
                y1 = self.maxpool(y, lay.k)
                y2 = self.maxpool(y1, lay.k)
                y3 = self.maxpool(y2, lay.k)
                y = g.op("Concat", [y, y1, y2, y3],
                         attrs=[_attr("axis", i=1)])
                cur = (self.conv(y, f"{name}.cv2", p["cv2"], 1),
                       (lay.c2, h, w))
            elif isinstance(lay, Y.Upsample):
                x, (c, h, w) = cur
                scales = g.init_tensor(
                    g.fresh("scales"),
                    np.asarray([1, 1, lay.scale, lay.scale], np.float32))
                y = g.op("Resize", [x, "", scales], attrs=[
                    _attr("mode", s="nearest"),
                    _attr("nearest_mode", s="floor"),
                    _attr("coordinate_transformation_mode", s="asymmetric"),
                ])
                cur = (y, (c, h * lay.scale, w * lay.scale))
            elif isinstance(lay, Y.Concat):
                names = [t for t, _ in cur]
                cs = [sh[0] for _, sh in cur]
                h, w = cur[0][1][1:]
                cur = (g.op("Concat", names, attrs=[_attr("axis", i=1)]),
                       (sum(cs), h, w))
            elif isinstance(lay, Y.Detect):
                xs = [t for t, _ in cur]
                hws = [sh[1:] for _, sh in cur]
                out = self.detect(xs, name, p, lay, hws)
                n_total = sum(lay.na * h * w for (h, w) in hws)
                cur = (out, (n_total, lay.no))
            else:
                raise NotImplementedError(
                    f"onnx emit for layer {type(lay).__name__}")
            if lay.i in self.model.save:
                saved[lay.i] = cur

        n_total, no = cur[1]
        vin = _value_info("input_image", ["batch_size", 3, *self.hw])
        vout = _value_info("predictions", ["batch_size", n_total, no])
        return g.serialize([vin], [vout], opset=16)


def export_yolo_onnx(model, state: Mapping[str, np.ndarray], path: str,
                     hw=(128, 128)) -> None:
    """Serialize a :class:`~lpr_tpu_torch.models.yolo.YoloModel`'s plan
    with its flat state (``load_yolo_torch``'s, or an npz's) as a
    reference-compatible detector ONNX graph: decode baked in, NMS
    excluded, dynamic batch, input "input_image" / output "predictions"
    (128x128 for the ocr model, 1280x1280 for the plate detector)."""
    data = _YoloEmitter(model, state, hw).build()
    with open(path, "wb") as f:
        f.write(data)


def export_lpsr_onnx(state: Mapping[str, np.ndarray], path: str,
                     cfg=None) -> None:
    """Serialize an LPSR flat state as a reference-compatible model.onnx
    (the reference's input/output names, opset, dynamic axes and
    initializer names)."""
    from lpr_tpu_torch.models.lpsr import LPSRConfig

    cfg = cfg or LPSRConfig()
    data = _LpsrEmitter(state, cfg).build()
    with open(path, "wb") as f:
        f.write(data)
