"""YOLOv5 ``.pt`` checkpoints written by the tests themselves: a pickled
``Model`` tree as the reference's trainer saves it (``torch.save({"model":
m, "ema": ...})``), whose classes stand in for the reference's under its
module names (``models.yolo.Model``, ``models.yolo.Detect``,
``models.common.Conv``, ``C3``, ``C3TR``, ``SPP``, ...), registered in
``sys.modules`` only while the file is written.  The weights are a flat
state (the repo's npz, or random arrays) laid out under the reference's
state-dict names by the port's name table
(:func:`lpr_tpu_torch.models.yolo.torch_names`); the JAX loader reads the
same file independently, so a wrong name fails there."""

import contextlib
import sys
import types

import numpy as np
import torch

from lpr_tpu_torch.models import yolo as tyolo

_COMMON = ("Conv", "DWConv", "Focus", "Bottleneck", "BottleneckCSP", "C3",
           "C3TR", "C3SPP", "C3Ghost", "GhostConv", "GhostBottleneck", "SPP",
           "SPPF", "Concat", "Contract", "Expand", "Classify",
           "TransformerBlock", "TransformerLayer")
_BN = (("gamma", "weight"), ("beta", "bias"), ("mean", "running_mean"),
       ("var", "running_var"))


def reference_modules():
    """``{module name: module}`` of stand-in classes under the reference's
    names; register them with :func:`registered`."""
    common = types.ModuleType("models.common")
    yolo = types.ModuleType("models.yolo")
    for mod, names in ((common, _COMMON), (yolo, ("Model", "Detect"))):
        for n in names:
            setattr(mod, n, type(n, (torch.nn.Module,),
                                 {"__module__": mod.__name__}))
    pkg = types.ModuleType("models")
    pkg.common, pkg.yolo = common, yolo
    return {"models": pkg, "models.common": common, "models.yolo": yolo}


@contextlib.contextmanager
def registered(mods):
    """``mods`` in ``sys.modules`` for the ``with`` body; whatever stood
    under those names before (or nothing) is put back afterwards, so the
    loaders read the file without them."""
    saved = {k: sys.modules[k] for k in mods if k in sys.modules}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for k in mods:
            sys.modules.pop(k, None)
        sys.modules.update(saved)


def torch_state_dict(model, state):
    """The flat state under the reference's state-dict names, OIHW conv and
    (out, in) Linear weights, each batch norm with its
    ``num_batches_tracked``."""
    sd = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def oihw(a):
        return t(np.transpose(a, (3, 2, 0, 1)))

    for kind, k, name in tyolo.torch_names(model):
        if kind in ("conv", "conv?"):
            if f"{k}/w" not in state:
                assert kind == "conv?", k
                continue
            sd[f"{name}.conv.weight"] = oihw(state[f"{k}/w"])
            if f"{k}/bn/gamma" in state:
                for key, tn in _BN:
                    sd[f"{name}.bn.{tn}"] = t(state[f"{k}/bn/{key}"])
                sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(7)
            elif f"{k}/b" in state:
                sd[f"{name}.conv.bias"] = t(state[f"{k}/b"])
        elif kind == "bn":
            for key, tn in _BN:
                sd[f"{name}.{tn}"] = t(state[f"{k}/{key}"])
        elif kind == "w":
            sd[name] = oihw(state[k])
        elif kind == "lin":
            sd[name] = t(np.asarray(state[k]).T)
        else:
            sd[name] = t(state[k])
    return sd


def _tree(mods, yaml_rows, sd, anchors, strides):
    """The pickled Model: ``model`` a Sequential of one stand-in a yaml
    row (``nn.Upsample`` a real Upsample), each holding its weights as
    parameters (running stats as buffers) of generic submodules."""
    root = mods["models.yolo"].Model()
    seq = torch.nn.Sequential()
    for i, (_, _, mname, _) in enumerate(yaml_rows):
        if mname == "nn.Upsample":
            lay = torch.nn.Upsample(scale_factor=2.0, mode="nearest")
        elif mname == "Detect":
            lay = mods["models.yolo"].Detect()
            lay.register_buffer("anchors", torch.from_numpy(
                np.asarray(anchors, np.float32)))
            lay.stride = torch.tensor(strides, dtype=torch.float32)
        else:
            lay = getattr(mods["models.common"], mname)()
        seq.add_module(str(i), lay)
    root.add_module("model", seq)
    for name, v in sd.items():
        *path, leaf = name.split(".")
        m = root
        for part in path:
            if part not in m._modules:
                m.add_module(part, torch.nn.Module())
            m = m._modules[part]
        if leaf.startswith(("running_", "num_batches")):
            m.register_buffer(leaf, v)
        else:
            m.register_parameter(leaf, torch.nn.Parameter(
                v, requires_grad=v.is_floating_point()))
    return root


def write_yolo_pt(path, spec, strides, state, names, *,
                  anchors=None, half=None, bf16=None, ema=False):
    """Write ``state`` for the port's build of ``spec`` as a YOLOv5 ``.pt``
    at ``path``: the Model's ``yaml`` (the spec's rows), ``names``,
    ``stride`` and the Detect ``anchors`` buffer (``anchors``, grid units,
    else the build's from the spec), beside ``best_fitness`` (a numpy
    float64) and an ``ema`` entry (None, or with ``ema`` the same Model,
    which the loaders prefer).  The torch names ``half`` and ``bf16`` are
    stored as float16 and bfloat16.  The stand-in classes are registered
    only while the file is written."""
    model = tyolo.build_yolo(spec, strides=strides, ckpt_anchors=anchors)
    sd = torch_state_dict(model, state)
    if half:
        sd[half] = sd[half].half()
    if bf16:
        sd[bf16] = sd[bf16].bfloat16()
    rows = [[r[0] if isinstance(r[0], int) else list(r[0]), r[1], r[2],
             list(r[3])] for r in list(spec.backbone) + list(spec.head)]
    mods = reference_modules()
    with registered(mods):
        m = _tree(mods, rows, sd, model.anchors, strides)
        m.yaml = {"nc": spec.nc, "depth_multiple": spec.depth_multiple,
                  "width_multiple": spec.width_multiple,
                  "anchors": spec.anchors, "backbone": rows[:len(
                      spec.backbone)], "head": rows[len(spec.backbone):]}
        m.names = list(names)
        m.stride = torch.tensor(strides, dtype=torch.float32)
        torch.save({"epoch": 3, "best_fitness": np.float64(0.25),
                    "model": m, "ema": m if ema else None, "updates": 12,
                    "optimizer": None}, path)
    return path
