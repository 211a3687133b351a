"""Minimal ONNX reader, numpy only (counterpart of
``lpr_tpu/weights/onnx_import.py``): raw protobuf wire-format parsing.

The reference exports and serves ONNX graphs (``my_utils/export_onnx.py``,
``onnx_models/*/1/model.onnx``); users migrating from it may hold them, and
the port's own emitter (:mod:`lpr_tpu_torch.weights.onnx_export`) writes
them.  No onnx package is needed: this module parses the protobuf wire
format directly, enough to extract every initializer (name, dims, dtype,
data), the node list (op type, inputs, outputs, attributes) and the graph's
input and output names.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

_ONNX_DTYPES = {
    1: np.dtype("<f4"), 2: np.dtype("u1"), 3: np.dtype("i1"),
    4: np.dtype("<u2"), 5: np.dtype("<i2"), 6: np.dtype("<i4"),
    7: np.dtype("<i8"), 9: np.dtype("?"), 10: np.dtype("<f2"),
    11: np.dtype("<f8"), 12: np.dtype("<u4"), 13: np.dtype("<u8"),
}


def _signed64(v: int) -> int:
    """Two's-complement int64 view of a varint.  Protobuf encodes negative
    int64 values as 10-byte varints whose raw unsigned value is >= 2**63;
    left unmasked they overflow np.int64 (-1 would parse as 2**64-1)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) records."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            v, i = _read_varint(buf, i)
        elif wt == 1:  # 64-bit
            v = buf[i : i + 8]
            i += 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            v = buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = np.dtype("<f4")
    name = ""
    raw = b""
    float_data: List[float] = []
    int64_data: List[int] = []
    for field, wt, v in _fields(buf):
        if field == 1:  # dims
            if wt == 0:
                dims.append(_signed64(v))
            else:  # packed
                i = 0
                while i < len(v):
                    d, i = _read_varint(v, i)
                    dims.append(_signed64(d))
        elif field == 2 and wt == 0:
            dtype = _ONNX_DTYPES.get(v, np.dtype("<f4"))
        elif field == 4:  # float_data (packed or single)
            if wt == 2:
                float_data.extend(struct.unpack(f"<{len(v)//4}f", v))
            else:
                float_data.append(struct.unpack("<f", v)[0])
        elif field == 7:  # int64_data
            if wt == 2:
                i = 0
                while i < len(v):
                    d, i = _read_varint(v, i)
                    int64_data.append(_signed64(d))
            else:
                int64_data.append(_signed64(v))
        elif field == 8 and wt == 2:
            name = v.decode("utf-8", "replace")
        elif field == 9 and wt == 2:
            raw = v
    if raw:
        arr = np.frombuffer(raw, dtype).copy()
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    else:
        arr = np.zeros(0, dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def _parse_attribute(buf: bytes) -> Tuple[str, Any]:
    """AttributeProto -> (name, value).  Supports INT/FLOAT/STRING/INTS/
    FLOATS/TENSOR (the types the zoo's graphs use)."""
    name, atype = "", 0
    i_val, f_val, s_val, t_val = 0, 0.0, b"", None
    ints: List[int] = []
    floats: List[float] = []
    for field, wt, v in _fields(buf):
        if field == 1 and wt == 2:
            name = v.decode("utf-8", "replace")
        elif field == 2 and wt == 5:
            f_val = struct.unpack("<f", v)[0]
        elif field == 3 and wt == 0:
            i_val = _signed64(v)
        elif field == 4 and wt == 2:
            s_val = v
        elif field == 5 and wt == 2:
            t_val = _parse_tensor(v)[1]
        elif field == 7:  # floats (packed or repeated)
            if wt == 2:
                floats.extend(struct.unpack(f"<{len(v)//4}f", v))
            else:
                floats.append(struct.unpack("<f", v)[0])
        elif field == 8:  # ints
            if wt == 2:
                i = 0
                while i < len(v):
                    d, i = _read_varint(v, i)
                    ints.append(_signed64(d))
            else:
                ints.append(_signed64(v))
        elif field == 20 and wt == 0:
            atype = v
    value = {1: f_val, 2: i_val, 3: s_val.decode("utf-8", "replace"),
             4: t_val, 6: floats, 7: ints}.get(atype)
    if value is None:  # untyped writer: infer from populated field
        value = ints or floats or i_val
    return name, value


def _parse_node(buf: bytes) -> Dict[str, Any]:
    node = {"inputs": [], "outputs": [], "op_type": "", "name": "",
            "attrs": {}}
    for field, wt, v in _fields(buf):
        if field == 1 and wt == 2:
            node["inputs"].append(v.decode("utf-8", "replace"))
        elif field == 2 and wt == 2:
            node["outputs"].append(v.decode("utf-8", "replace"))
        elif field == 3 and wt == 2:
            node["name"] = v.decode("utf-8", "replace")
        elif field == 4 and wt == 2:
            node["op_type"] = v.decode("utf-8", "replace")
        elif field == 5 and wt == 2:
            k, val = _parse_attribute(v)
            node["attrs"][k] = val
    return node


def load_onnx(path: str) -> Dict[str, Any]:
    """Parse an .onnx file -> {"initializers": {name: ndarray},
    "nodes": [...], "inputs": [names], "outputs": [names]}."""
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wt, v in _fields(model):  # ModelProto
        if field == 7 and wt == 2:  # graph
            graph = v
    if graph is None:
        raise ValueError(f"{path}: no graph found")
    init: Dict[str, np.ndarray] = {}
    nodes: List[Dict[str, Any]] = []
    g_inputs: List[str] = []
    g_outputs: List[str] = []
    for field, wt, v in _fields(graph):  # GraphProto
        if field == 1 and wt == 2:
            nodes.append(_parse_node(v))
        elif field == 5 and wt == 2:
            name, arr = _parse_tensor(v)
            init[name] = arr
        elif field in (11, 12) and wt == 2:
            # ValueInfoProto: field 1 = name
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:
                    (g_inputs if field == 11 else g_outputs).append(
                        v2.decode("utf-8", "replace")
                    )
    return {"initializers": init, "nodes": nodes,
            "inputs": g_inputs, "outputs": g_outputs}


def onnx_to_torch_names(onnx_path: str) -> Dict[str, np.ndarray]:
    """Best-effort mapping of ONNX initializer names back to torch state-dict
    names (torch exporters keep ``module.path.weight`` names for weights)."""
    data = load_onnx(onnx_path)
    out = {}
    for name, arr in data["initializers"].items():
        key = name
        if key.startswith("onnx::"):
            continue
        out[key] = arr
    return out
