"""Layout conversion from PyTorch state dicts to the port's flat state
(counterpart of ``lpr_tpu/weights/convert.py``), numpy only.

torch conv weights are OIHW; the state keeps the JAX package's HWIO (NHWC
activations), which :class:`lpr_tpu_torch.ops.nn.Conv2d` turns back into
OIHW at load.  Depthwise convs (torch ``groups=C``, weight (C, 1, kh, kw))
become HWIO with I=1, O=C.  Linear weights are (out, in) in torch and
(in, out) here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def conv_w(t: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.ascontiguousarray(np.transpose(np.asarray(t, np.float32),
                                             (2, 3, 1, 0)))


def dw_conv_w(t: np.ndarray) -> np.ndarray:
    """torch depthwise (C, 1, kh, kw) -> HWIO (kh, kw, 1, C)."""
    return np.ascontiguousarray(np.transpose(np.asarray(t, np.float32),
                                             (2, 3, 1, 0)))


def linear_w(t: np.ndarray) -> np.ndarray:
    """(out, in) -> (in, out)."""
    return np.ascontiguousarray(np.asarray(t, np.float32).T)


def vec(t: np.ndarray) -> np.ndarray:
    return np.asarray(t, np.float32)


def subdict(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """The entries under ``prefix``, with the prefix taken off their keys."""
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}
