"""Typed configuration saved to and loaded from YAML files (counterpart of
``lpr_tpu/config.py``).

Every component has one frozen dataclass config; :data:`REGISTRY` names
them by the JAX package's kinds, and :func:`save_config` /
:func:`load_config` round-trip any of them.  The card's machine has no
yaml package, so this module writes and reads the subset that
``save_config`` writes, as PyYAML's ``safe_dump`` spells it: a mapping of
``kind`` and ``values``, scalars (null, booleans, ints, floats, strings)
and nested lists in block style.  A file written by either package loads
in the other to equal fields.  A dtype is written as ``str(dtype)`` (``torch.bfloat16``;
the JAX package writes ``<class 'jax.numpy.bfloat16'>``) and read by its
last name; an unknown one raises (the JAX loader takes float32).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Tuple, Type, TypeVar

import torch

from lpr_tpu_torch.data.degradation import DegradationConfig
from lpr_tpu_torch.models.cyclegan import GeneratorConfig
from lpr_tpu_torch.models.lpsr import LPSRConfig
from lpr_tpu_torch.pipeline.recognizer import PipelineConfig
from lpr_tpu_torch.train.cyclegan import CycleGANConfig
from lpr_tpu_torch.train.lpsr import LPSRTrainConfig
from lpr_tpu_torch.train.yolo import YoloTrainConfig
from lpr_tpu_torch.train.yolo_loss import YoloLossConfig

T = TypeVar("T")

REGISTRY: Dict[str, type] = {
    "lpsr": LPSRConfig,
    "lpsr_train": LPSRTrainConfig,
    "pipeline": PipelineConfig,
    "cyclegan_gen": GeneratorConfig,
    "cyclegan_train": CycleGANConfig,
    "degradation": DegradationConfig,
    "yolo_train": YoloTrainConfig,
    "yolo_loss": YoloLossConfig,
}

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "float64": torch.float64}

# YAML 1.1's implicit scalars, as PyYAML's resolver reads them (decimal
# ints; floats with a dot, and .inf / .nan)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


def yaml_float(v: float) -> str:
    """A float as PyYAML's ``represent_float`` writes it."""
    if v != v:
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    s = repr(float(v)).lower()
    if "." not in s and "e" in s:
        s = s.replace("e", ".0e", 1)
    return s


def _resolve(s: str) -> Any:
    """A plain scalar's value."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t.startswith("-") else math.inf
        return math.nan if t.endswith(".nan") else float(t)
    return s


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return yaml_float(v)
    if isinstance(v, list):
        if v:
            raise ValueError("a non-empty list is not a scalar")
        return "[]"
    s = str(v)
    lead_ok = s and (s[0] not in _INDICATORS or (
        s[0] in "-?:" and len(s) > 1 and s[1] != " "))
    plain = (lead_ok and s == s.strip()
             and ": " not in s and " #" not in s and "\n" not in s
             and not s.endswith(":") and isinstance(_resolve(s), str))
    return s if plain else "'" + s.replace("'", "''") + "'"


def _seq_lines(seq: List[Any], col: int) -> List[str]:
    out = []
    for item in seq:
        if isinstance(item, list) and item:
            sub = _seq_lines(item, col + 2)
            out.append(" " * col + "- " + sub[0][col + 2:])
            out.extend(sub[1:])
        else:
            out.append(" " * col + "- " + _scalar(item))
    return out


def dump(data: Dict[str, Any]) -> str:
    """``yaml.safe_dump(data, sort_keys=False)`` for a mapping of scalars,
    lists and mappings of those."""
    def mapping(d: Dict[str, Any], col: int) -> List[str]:
        out = []
        for k, v in d.items():
            head = " " * col + f"{k}:"
            if isinstance(v, dict) and v:
                out.append(head)
                out.extend(mapping(v, col + 2))
            elif isinstance(v, list) and v:
                out.append(head)
                out.extend(_seq_lines(v, col))
            else:
                out.append(head + " " + ("{}" if isinstance(v, dict)
                                         else _scalar(v)))
        return out

    return "\n".join(mapping(data, 0)) + "\n"


def _unquote(s: str) -> Any:
    if s.startswith("'"):
        if not s.endswith("'") or len(s) < 2:
            raise ValueError(f"unterminated quoted scalar {s!r}")
        return s[1:-1].replace("''", "'")
    if s.startswith('"'):
        import json

        return json.loads(s)
    if s == "[]":
        return []
    if s == "{}":
        return {}
    if s.startswith(("[", "{")):
        raise ValueError(f"flow collections other than [] and {{}} are not "
                         f"read: {s!r}")
    return _resolve(s)


def _split_key(text: str):
    """(key, rest) of a ``key: value`` / ``key:`` line, else None."""
    m = re.match(r"^([^'\"\[\]{}#:][^:#]*?|'[^']*'):(?: (.*))?$", text)
    if m is None:
        return None
    key = m.group(1)
    return (_unquote(key) if key.startswith("'") else key,
            (m.group(2) or "").strip())


def load(text: str) -> Any:
    """Parse the YAML subset :func:`dump` and ``safe_dump`` write for a
    config: block mappings, block sequences (indentless under a key),
    empty ``[]`` and ``{}``, quoted and plain scalars."""
    lines = [(len(l) - len(l.lstrip(" ")), l.strip())
             for l in text.splitlines()
             if l.strip() and not l.lstrip().startswith("#")
             and l.strip() not in ("---", "...")]

    def node(i: int, col: int) -> Tuple[Any, int]:
        if lines[i][1] == "-" or lines[i][1].startswith("- "):
            return seq(i, col)
        if _split_key(lines[i][1]) is not None:
            return mapping(i, col)
        if i + 1 < len(lines) and lines[i + 1][0] >= col:
            raise ValueError(f"unexpected text after {lines[i][1]!r}")
        return _unquote(lines[i][1]), i + 1

    def child(i: int, col: int, rest: str, seq_at_col: bool):
        """The value of a key or item whose text after the indicator is
        ``rest``, its lines below starting at ``i``."""
        if rest:
            return _unquote(rest), i
        if i < len(lines):
            c, t = lines[i]
            if c > col or (seq_at_col and c == col
                           and (t == "-" or t.startswith("- "))):
                return node(i, c)
        return None, i

    def seq(i: int, col: int):
        out = []
        while i < len(lines) and lines[i][0] == col and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][2:].strip()
            if rest.startswith("- ") or rest == "-" or (
                    _split_key(rest) is not None):
                lines[i] = (col + 2, rest)      # a node that starts here
                val, i = node(i, col + 2)
            else:
                val, i = child(i + 1, col, rest, False)
            out.append(val)
        return out, i

    def mapping(i: int, col: int):
        out = {}
        while i < len(lines) and lines[i][0] == col:
            kv = _split_key(lines[i][1])
            if kv is None:
                break
            out[kv[0]], i = child(i + 1, col, kv[1], True)
        return out, i

    if not lines:
        return None
    val, i = node(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"could not read line {lines[i][1]!r}")
    return val


def _to_plain(v: Any) -> Any:
    if isinstance(v, (list, tuple)):
        return [_to_plain(x) for x in v]
    if isinstance(v, (torch.dtype, type)):
        return str(v)
    return v


def save_config(path: str, cfg: Any) -> None:
    name = next((k for k, c in REGISTRY.items() if isinstance(cfg, c)), None)
    data = {
        "kind": name or type(cfg).__name__,
        "values": {f.name: _to_plain(getattr(cfg, f.name))
                   for f in dataclasses.fields(cfg)
                   if not str(f.name).startswith("_")},
    }
    with open(path, "w") as f:
        f.write(dump(data))


def _dtype(key: str, v: str) -> torch.dtype:
    name = v.split(".")[-1].strip("'><class \"")
    if name not in DTYPES:
        raise ValueError(f"{key}: unknown dtype {v!r} (known: "
                         f"{sorted(DTYPES)})")
    return DTYPES[name]


def load_config(path: str, cls: Type[T] = None) -> T:
    with open(path) as f:
        data = load(f.read())
    if cls is None:
        cls = REGISTRY[data["kind"]]
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in (data.get("values") or {}).items():
        if k not in fields:
            continue
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        if isinstance(v, str) and ("dtype" in k or k == "compute_dtype"
                                   or k == "weight_dtype"):
            v = _dtype(k, v)
        kwargs[k] = v
    return cls(**kwargs)
