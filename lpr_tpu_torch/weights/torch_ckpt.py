"""PyTorch ``.pt``/``.pth`` checkpoints that hold a plain state dict (the
plain-state-dict part of ``lpr_tpu/weights/torch_ckpt.py``).

:func:`load_state_dict` reads one with ``torch.load(weights_only=True)``,
which unpickles tensors and containers and nothing else.  A checkpoint
that pickles a module (the reference's ``char.pt``) does not load here: its
import, through a restricted unpickler, is queued with the ONNX import
(ROADMAP section 1, item 5).
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """``{name: ndarray}`` of a raw state dict or of the
    ``{"model_state_dict": ...}`` wrapper the reference trainers write;
    bf16/fp16 values come back as float32.  Raises ValueError for a
    checkpoint that pickles a module or is not a state dict."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} pickles more than tensors (a module?): the port loads "
            f"plain state dicts only; pickled-module checkpoints are queued "
            f"with the ONNX import (ROADMAP section 1, item 5)") from e
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if not (isinstance(obj, dict) and obj
            and all(isinstance(v, torch.Tensor) for v in obj.values())):
        raise ValueError(f"{path} is not a plain state-dict checkpoint")
    return {k: (v.float() if v.dtype in (torch.bfloat16, torch.float16)
                else v).detach().numpy() for k, v in obj.items()}
