"""Numpy-only reader for the repo's flat npz checkpoints.

Counterpart of ``lpr_tpu/weights/checkpoint.py``.  A checkpoint is an npz
whose keys are parameter-pytree paths joined with ``/`` (``0/w`` is an HWIO
conv weight, ``0/bn/gamma`` a batch-norm scale, ``2/m/0/cv1/w`` a nested
one) plus side keys such as ``__anchors__`` that are not parameters.

The port's parameter *state* is that flat mapping, ``{path: float32
ndarray}``; the model modules build their tensors from it.
:func:`params_from_jax` turns the JAX package's parameter pytree (with
numpy leaves) into the same state, so weights carry across exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

State = Dict[str, np.ndarray]


def is_side_key(key: str) -> bool:
    """Side keys (``__anchors__``) carry metadata, not parameters."""
    return key.startswith("__") and key.endswith("__")


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every key of the npz, values exactly as stored."""
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def load_state(path: str) -> Tuple[State, Dict[str, np.ndarray]]:
    """``(state, side)``: parameters cast to float32 (as the JAX loader
    casts them to its float32 init pytree) and the side keys as stored."""
    raw = read_npz(path)
    state = {k: v.astype(np.float32) for k, v in raw.items()
             if not is_side_key(k)}
    side = {k: v for k, v in raw.items() if is_side_key(k)}
    return state, side


def params_from_jax(tree: Any) -> State:
    """Flatten a JAX parameter pytree (nested dicts, lists and tuples with
    array leaves, e.g. ``jax.device_get(params)``) into the port's state,
    with the key paths ``lpr_tpu.weights.checkpoint.save_params`` writes."""
    out: State = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif node is not None:
            out["/".join(path)] = np.asarray(node, np.float32)

    walk(tree, ())
    return out
