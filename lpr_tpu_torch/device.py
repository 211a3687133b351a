"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``.  There is no silent fallback: a
missing card raises, and the CPU is used only when the caller asks for it.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names a CUDA
    device and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); this entry point runs on an NVIDIA card by default — "
            "pass device='cpu' to run on the CPU")
    return dev
