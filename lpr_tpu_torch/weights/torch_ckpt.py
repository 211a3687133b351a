"""Safe reader for PyTorch zip checkpoints (counterpart of
``lpr_tpu/weights/torch_ckpt.py``).

The reference ships full *pickled nn.Module* checkpoints
(``weights/char.pt``, which its ``attempt_load`` reads with ``torch.load``,
executing whatever the pickle says) and plain state-dict checkpoints
(``weights/best_model.pth``).  This module never calls ``torch.load`` and
never imports a pickled class: it parses the pickle stream with a
restricted unpickler that

- resolves every global outside a short allow-list to a generic
  :class:`Stub` that only records its constructor arguments and state, so
  no pickled code runs;
- rebuilds tensors as torch tensors straight from the zip's storage
  entries (``torch.frombuffer``, ``as_strided``, ``contiguous``: the
  rebuild of ``torch._utils._rebuild_tensor_v2``), bfloat16 storages
  included;
- exposes module trees as nested stubs, which :func:`module_state_dict`
  walks (``_parameters`` / ``_buffers`` / ``_modules``) into a flat
  ``name -> tensor`` state dict, and :class:`YoloCheckpoint` reads for a
  YOLOv5 checkpoint's yaml, class names, anchors and strides.

Like the JAX package's reader it allows ``numpy.core.multiarray``'s
``scalar`` and ``_reconstruct`` and nothing under ``numpy._core``: numpy 2
pickles its scalars (a YOLOv5 checkpoint's ``best_fitness``) under
``numpy._core.multiarray.scalar``, and both readers return those as a
:class:`Stub`.
"""

from __future__ import annotations

import io
import pickle
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

_STORAGE_DTYPES = {
    "FloatStorage": torch.float32,
    "DoubleStorage": torch.float64,
    "HalfStorage": torch.float16,
    "BFloat16Storage": torch.bfloat16,
    "LongStorage": torch.int64,
    "IntStorage": torch.int32,
    "ShortStorage": torch.int16,
    "CharStorage": torch.int8,
    "ByteStorage": torch.uint8,
    "BoolStorage": torch.bool,
}


class Stub:
    """Generic stand-in for any class the pickle names.

    Records positional args (``_stub_args``) and the pickled state
    (``__dict__``) without running any real constructor.
    """

    _stub_name = "?"

    def __init__(self, *args, **kwargs):
        self._stub_args = args
        if kwargs:
            self.__dict__.update(kwargs)

    @classmethod
    def _new(cls, *args):  # for the __newobj__ reduce protocol
        obj = cls.__new__(cls)
        obj._stub_args = args
        return obj

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2:
            # (dict_state, slots_state)
            d, s = state
            if d:
                self.__dict__.update(d)
            if s:
                self.__dict__.update(s)
        else:
            self.__dict__["_stub_state"] = state

    def __repr__(self):
        return f"<Stub {self._stub_name}>"


class _LazyStorage:
    """A torch storage of the checkpoint zip, read at its first use."""

    __slots__ = ("dtype", "key", "numel", "_zf", "_prefix", "_cache")

    def __init__(self, dtype, key, numel, zf, prefix):
        self.dtype = dtype
        self.key = key
        self.numel = numel
        self._zf = zf
        self._prefix = prefix
        self._cache = None

    def data(self) -> torch.Tensor:
        """The storage as a flat tensor of its dtype (little-endian bytes,
        as ``torch.save`` writes them)."""
        if self._cache is None:
            raw = bytearray(self._zf.read(f"{self._prefix}/data/{self.key}"))
            self._cache = (torch.frombuffer(raw, dtype=self.dtype) if raw
                           else torch.empty(0, dtype=self.dtype))
        return self._cache


def _rebuild_tensor_v2(storage, storage_offset, size, stride, *args):
    """``torch._utils._rebuild_tensor_v2`` on a :class:`_LazyStorage`: a
    contiguous tensor of the view."""
    if not isinstance(storage, _LazyStorage):
        raise ValueError(f"unexpected storage {type(storage)}")
    flat = storage.data()
    return flat.as_strided(tuple(size), tuple(stride),
                           int(storage_offset)).contiguous()


def _rebuild_parameter(data, requires_grad=True, hooks=None):
    return data


def _identity(*args):
    return args[0] if args else None


def _np_scalar(dt, b):
    return np.frombuffer(b, dt)[0]


def _np_reconstruct(subtype, shape, dtype):
    return np.ndarray.__new__(np.ndarray, shape, dtype)


class _AttrDict(dict):
    """dict that tolerates pickle BUILD state (torch OrderedDicts carry a
    ``_metadata`` attribute)."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            for k, v in state.items():
                object.__setattr__(self, "_attr_" + k, v)


class _RestrictedUnpickler(pickle.Unpickler):
    _ALLOWED = {
        ("collections", "OrderedDict"): _AttrDict,
        ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
        ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
        ("torch._utils", "_rebuild_tensor"): _rebuild_tensor_v2,
        ("torch.serialization", "_get_layout"): _identity,
        ("numpy.core.multiarray", "scalar"): _np_scalar,
        ("numpy.core.multiarray", "_reconstruct"): _np_reconstruct,
        ("numpy", "dtype"): np.dtype,
        ("numpy", "ndarray"): np.ndarray,
        ("_codecs", "encode"): lambda s, enc: s.encode(enc),
    }

    def __init__(self, file, zf: zipfile.ZipFile, prefix: str):
        super().__init__(file)
        self._zf = zf
        self._prefix = prefix
        self._stub_cache: Dict[str, type] = {}

    def find_class(self, module: str, name: str):
        key = (module, name)
        if key in self._ALLOWED:
            return self._ALLOWED[key]
        if module.startswith("torch") and name in _STORAGE_DTYPES:
            return _STORAGE_DTYPES[name]
        # Everything else (torch modules, model classes, ...) -> stub class.
        full = f"{module}.{name}"
        if full not in self._stub_cache:
            self._stub_cache[full] = type(
                f"Stub_{name}", (Stub,), {"_stub_name": full}
            )
        return self._stub_cache[full]

    def persistent_load(self, saved_id):
        # ('storage', storage_type, key, location, numel)
        if isinstance(saved_id, tuple) and saved_id and saved_id[0] == "storage":
            _, storage_type, key, _location, numel = saved_id
            dtype = (storage_type if isinstance(storage_type, torch.dtype)
                     else torch.float32)
            return _LazyStorage(dtype, key, numel, self._zf, self._prefix)
        raise pickle.UnpicklingError(f"unsupported persistent id {saved_id!r}")


def load_checkpoint(path: str) -> Any:
    """Parse a PyTorch zip checkpoint without executing any code.

    Returns the checkpoint object with tensors as torch tensors (on the
    CPU) and arbitrary classes replaced by :class:`Stub` instances.
    """
    zf = zipfile.ZipFile(path)
    names = zf.namelist()
    pkl = next(n for n in names if n.endswith("/data.pkl"))
    prefix = pkl[: -len("/data.pkl")]
    up = _RestrictedUnpickler(io.BytesIO(zf.read(pkl)), zf, prefix)
    return up.load()


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """A state tensor as numpy: bfloat16 and float16 as float32 (numpy has
    no bfloat16), every other dtype as stored."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def module_state_dict(mod: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Walk a stubbed nn.Module tree into a flat ``name -> tensor`` dict.

    Mirrors torch's ``Module.state_dict()`` naming (parameters then buffers,
    recursing through ``_modules``).  Shared submodules (e.g. the reference
    LPSR's shared CSAR instance) appear once per path, like torch's
    state_dict.
    """
    out: Dict[str, torch.Tensor] = {}
    params = getattr(mod, "_parameters", None) or {}
    for k, v in params.items():
        if _is_tensor(v):
            out[prefix + k] = v
    bufs = getattr(mod, "_buffers", None) or {}
    for k, v in bufs.items():
        if _is_tensor(v):
            out[prefix + k] = v
    mods = getattr(mod, "_modules", None) or {}
    for k, v in mods.items():
        if v is not None:
            out.update(module_state_dict(v, prefix + k + "."))
    return out


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """``{name: ndarray}`` of a checkpoint that is (or wraps) a plain state
    dict: a raw ``{name: tensor}`` dict or the ``{"model_state_dict": ...}``
    wrapper the reference trainers write.  bfloat16 and float16 values come
    back as float32.  Raises ValueError for anything else (a pickled
    module, a dict holding more than tensors)."""
    obj = load_checkpoint(path)
    if isinstance(obj, dict):
        if "model_state_dict" in obj:
            obj = obj["model_state_dict"]
        if all(_is_tensor(v) for v in obj.values()):
            return {k: _as_numpy(v) for k, v in obj.items()}
    raise ValueError(f"{path} is not a plain state-dict checkpoint")


class YoloCheckpoint:
    """Structured view of a pickled-YOLOv5-Model checkpoint (e.g. char.pt):
    the architecture yaml dict, class names, per-level anchors (grid units,
    from the Detect buffer) and strides, hyperparameters, and the flat
    state dict as numpy with every float as float32, all recovered without
    running any pickled code (the reference's counterpart:
    ``yolov5/models/experimental.py:90-99``).  ``prefer_ema`` reads the
    EMA model where the checkpoint holds one."""

    def __init__(self, path: str, prefer_ema: bool = True):
        ckpt = load_checkpoint(path)
        if not isinstance(ckpt, dict) or "model" not in ckpt:
            raise ValueError(f"{path}: expected a YOLOv5 train checkpoint dict")
        self.raw = ckpt
        model = None
        if prefer_ema and ckpt.get("ema") is not None:
            model = ckpt["ema"]
        if model is None or not hasattr(model, "_modules"):
            model = ckpt["model"]
        self.model = model
        self.yaml: Dict[str, Any] = dict(getattr(model, "yaml", {}) or {})
        self.names = list(getattr(model, "names", []) or [])
        self.hyp: Optional[Dict[str, Any]] = getattr(model, "hyp", None)
        self.state_dict = {
            k: (v.float() if v.is_floating_point() else v).numpy()
            for k, v in module_state_dict(model).items()
        }
        # Detect head metadata
        self.anchors = None
        self.stride = None
        for k, v in self.state_dict.items():
            if k.endswith(".anchors"):
                self.anchors = np.asarray(v, np.float32)  # (nl, na, 2), grid units
        strides = getattr(model, "stride", None)
        if _is_tensor(strides):
            self.stride = strides.float().numpy()

    @property
    def nc(self) -> int:
        return int(self.yaml.get("nc", len(self.names) or 0))
