"""Reference executor for imported or emitted ONNX graphs, in PyTorch
(counterpart of ``lpr_tpu/weights/onnx_run.py``).

Runs the op subset of the project's three model families (the
reference's ``onnx_models/sr/1/model.onnx``, the port's own
:mod:`~lpr_tpu_torch.weights.onnx_export` output and torch-exported YOLO
graphs' common core) on the device of the tensors it is fed, so that a
user holding the reference's ONNX artifacts can run them without
onnxruntime, and the emitter's graph semantics (not just its weights) can
be held against the models' own forwards.

Not a general runtime: static single-assignment evaluation in file order,
float32, convolutions through ``torch.nn.functional.conv2d``.  This is a
reference, not one of the port's kernels.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _ints(v) -> List[int]:
    if isinstance(v, Tensor):
        return [int(a) for a in v.reshape(-1).tolist()]
    return [int(a) for a in np.asarray(v).reshape(-1)]


def _conv(x: Tensor, w: Tensor, b: Optional[Tensor], attrs) -> Tensor:
    strides = tuple(attrs.get("strides", [1, 1]))
    pads = attrs.get("pads", [0, 0, 0, 0])
    dil = tuple(attrs.get("dilations", [1, 1]))
    groups = int(attrs.get("group", 1))
    auto_pad = attrs.get("auto_pad", "NOTSET")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        padding = []
        for ax in range(2):
            in_sz = x.shape[2 + ax]
            k_eff = (w.shape[2 + ax] - 1) * dil[ax] + 1
            out_sz = -(-in_sz // strides[ax])  # ceil
            total = max((out_sz - 1) * strides[ax] + k_eff - in_sz, 0)
            lo = total // 2 if auto_pad == "SAME_UPPER" else total - total // 2
            padding.append((lo, total - lo))
    else:
        padding = [(pads[0], pads[2]), (pads[1], pads[3])]
    (t, bo), (le, r) = padding
    if t == bo and le == r:
        return F.conv2d(x.float(), w.float(), None if b is None else b.float(),
                        strides, (t, le), dil, groups)
    x = F.pad(x.float(), (le, r, t, bo))
    return F.conv2d(x, w.float(), None if b is None else b.float(), strides,
                    0, dil, groups)


def _depth_to_space(x: Tensor, blocksize, mode="DCR") -> Tensor:
    n, c, h, w = x.shape
    r = int(blocksize)
    mode = mode.decode() if isinstance(mode, bytes) else str(mode)
    if mode == "CRD":  # torch PixelShuffle order
        y = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    else:  # DCR
        y = x.reshape(n, r, r, c // (r * r), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (r * r), h * r, w * r)


def _pad(x: Tensor, pads, value: float = 0.0) -> Tensor:
    pads = _ints(pads)
    k = len(pads) // 2
    flat: List[int] = []
    for i in reversed(range(k)):        # F.pad takes the last axis first
        flat += [pads[i], pads[i + k]]
    return F.pad(x, flat, value=value)


def _slice(data: Tensor, starts, ends, axes=None, steps=None) -> Tensor:
    nd = data.dim()
    starts, ends = _ints(starts), _ints(ends)
    axes = list(range(nd)) if axes is None else [a % nd for a in _ints(axes)]
    steps = [1] * len(axes) if steps is None else _ints(steps)
    for a, s, e, st in zip(axes, starts, ends, steps):
        lo, hi, st = slice(s, e, st).indices(int(data.shape[a]))
        if st > 0:
            data = data[(slice(None),) * a + (slice(lo, hi, st),)]
        else:                               # torch slices take no step < 0
            data = data.index_select(a, torch.arange(
                lo, hi, st, dtype=torch.int64, device=data.device))
    return data


def _gather(x: Tensor, idx: Tensor, axis: int) -> Tensor:
    axis %= x.dim()
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    y = x.index_select(axis, idx.reshape(-1))
    return y.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                     + tuple(x.shape[axis + 1:]))


def _max_pool(x: Tensor, a) -> Tensor:
    k = a["kernel_shape"]
    pads = a.get("pads", [0] * 4)
    st = a.get("strides", [1, 1])
    z = F.pad(x.float(), (pads[1], pads[3], pads[0], pads[2]),
              value=-float("inf"))
    return F.max_pool2d(z, tuple(k), tuple(st))


def _resize(x: Tensor, scales, a) -> Tensor:
    mode = a.get("mode", b"nearest")
    mode = mode.decode() if isinstance(mode, bytes) else str(mode)
    if mode != "nearest":
        raise NotImplementedError(f"Resize mode {mode}")
    y = x
    for ax, sc in enumerate(scales.float().reshape(-1).tolist()):
        r = int(round(sc))
        if r != 1:
            y = y.repeat_interleave(r, dim=ax)
    return y


def _tensor(v, device) -> Tensor:
    if isinstance(v, Tensor):
        return v.to(device)
    return torch.from_numpy(np.array(v, copy=True)).to(device)


def run_onnx(graph: Dict[str, Any], feeds: Dict[str, Any],
             outputs: Optional[Sequence[str]] = None,
             device=None) -> List[Tensor]:
    """Evaluate :func:`~lpr_tpu_torch.weights.onnx_import.load_onnx`'s
    dict form on ``feeds`` (tensors or arrays) and return the graph's
    outputs (or ``outputs`` if given) as tensors.  Runs on ``device``,
    which defaults to the device of the first tensor fed (the CPU for
    arrays); the initializers are copied there."""
    if device is None:
        device = next((v.device for v in feeds.values()
                       if isinstance(v, Tensor)), torch.device("cpu"))
    env: Dict[str, Tensor] = {k: _tensor(v, device)
                              for k, v in graph["initializers"].items()}
    env.update({k: _tensor(v, device) for k, v in feeds.items()})

    def get(name):
        return env[name] if name else None

    for node in graph["nodes"]:
        op = node["op_type"]
        a = node.get("attrs", {})
        ins = node["inputs"]
        x = get(ins[0]) if ins else None
        if op == "Conv":
            y = _conv(x, get(ins[1]), get(ins[2]) if len(ins) > 2 else None, a)
        elif op == "Relu":
            y = torch.relu(x)
        elif op == "Sigmoid":
            y = torch.sigmoid(x.float())
        elif op == "Add":
            y = x + get(ins[1])
        elif op == "Sub":
            y = x - get(ins[1])
        elif op == "Mul":
            y = x * get(ins[1])
        elif op == "Div":
            b = get(ins[1])
            y = (torch.div(x, b, rounding_mode="floor")
                 if not x.is_floating_point() else x / b)
        elif op == "Mod":
            y = torch.remainder(x, get(ins[1]))
        elif op == "Concat":
            y = torch.cat([get(i) for i in ins], int(a.get("axis", 0)))
        elif op == "Reshape":
            shape = _ints(get(ins[1]))
            y = x.reshape([x.shape[i] if v == 0 else v
                           for i, v in enumerate(shape)])
        elif op == "Transpose":
            y = x.permute(*a["perm"])
        elif op == "DepthToSpace":
            y = _depth_to_space(x, a["blocksize"], a.get("mode", "DCR"))
        elif op == "Gather":
            y = _gather(x, get(ins[1]), int(a.get("axis", 0)))
        elif op == "Shape":
            y = torch.tensor(tuple(x.shape), dtype=torch.int64, device=device)
        elif op == "Pad":
            value = (float(get(ins[2])) if len(ins) > 2 and ins[2] else 0.0)
            y = _pad(x, get(ins[1]), value)
        elif op == "Gemm":
            w = get(ins[1])
            if int(a.get("transB", 0)):
                w = w.T
            y = (float(a.get("alpha", 1.0)) * (x @ w)
                 + float(a.get("beta", 1.0)) * get(ins[2]))
        elif op == "Flatten":
            ax = int(a.get("axis", 1))
            lead = int(np.prod(x.shape[:ax])) if ax else 1
            y = x.reshape(lead or 1, -1)
        elif op == "GlobalAveragePool":
            y = x.float().mean(dim=(2, 3), keepdim=True)
        elif op == "Unsqueeze":
            y = x
            axes = _ints(get(ins[1]) if len(ins) > 1 else a["axes"])
            for ax in sorted(axes):
                y = y.unsqueeze(ax)
        elif op == "Squeeze":
            axes = get(ins[1]) if len(ins) > 1 else a.get("axes")
            y = (x.squeeze() if axes is None
                 else x.squeeze(tuple(_ints(axes))))
        elif op == "Slice":
            y = _slice(x, get(ins[1]), get(ins[2]),
                       get(ins[3]) if len(ins) > 3 else None,
                       get(ins[4]) if len(ins) > 4 else None)
        elif op == "Constant":
            y = _tensor(a.get("value"), device)
        elif op == "Identity":
            y = x
        elif op == "MatMul":
            y = x.float() @ get(ins[1]).float()
        elif op == "Softmax":
            y = torch.softmax(x.float(), int(a.get("axis", -1)))
        elif op == "LeakyRelu":
            y = F.leaky_relu(x.float(), float(a.get("alpha", 0.01)))
        elif op == "MaxPool":
            y = _max_pool(x, a)
        elif op == "Resize":
            y = _resize(x, get(ins[2]) if len(ins) > 2 and ins[2] else None,
                        a)
        else:
            raise NotImplementedError(f"onnx op {op}")
        env[node["outputs"][0]] = y

    wanted = list(outputs) if outputs is not None else graph["outputs"]
    return [env[n] for n in wanted]
