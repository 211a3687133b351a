"""Portable model export with ``torch.export`` (counterpart of
``lpr_tpu/weights/export_stablehlo.py``, which serializes ``jax.export``
artifacts).

An artifact (``.pt2``, ``torch.export.save``) holds the traced graph with
its weights at fixed example shapes, and loads back into a callable
without the model code.  As the JAX package exports its plain forwards,
not its Pallas kernels, this module exports the plain ``LPSR.forward`` and
the detector's ``forward(x, decode=True)`` predictions: the hand-written
kernels are ctypes calls that a trace cannot hold, and a trace that
reaches one raises (:func:`lpr_tpu_torch.kernels.refuse_export`).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from lpr_tpu_torch.device import DeviceLike, resolve_device


def _device(module: torch.nn.Module) -> torch.device:
    """The device of the module's first buffer (the port's layers hold
    their weights as buffers)."""
    return next(module.buffers()).device


class _Fn(torch.nn.Module):
    """A callable as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _Predictions(torch.nn.Module):
    """A detector's decoded predictions (B, N, 5+nc) as float32, NMS
    excluded (the reference's detector export contract)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x, decode=True)[0].float()


def export_fn(fn: Callable, example_args: Sequence[Any], path: str) -> None:
    """Trace ``fn`` (a module or a callable) at the example arguments'
    shapes and ``torch.export.save`` the program to ``path``."""
    mod = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    with torch.no_grad():
        ep = torch.export.export(mod, tuple(example_args), strict=False)
    torch.export.save(ep, path)


def load_fn(path: str) -> Callable:
    """Load an artifact back into a callable (on the devices it was traced
    on)."""
    return torch.export.load(path).module()


def export_lpsr(lpsr, path: str, batch: int = 16, hw=(32, 192), cfg=None,
                device: DeviceLike = "cuda") -> None:
    """Export the LPSR forward with its weights: ``lpsr`` is an
    :class:`~lpr_tpu_torch.models.lpsr.LPSR` (traced on its own device) or
    a flat state (built with ``cfg`` on ``device``); the input is NHWC
    (batch, H, W, 3) float32."""
    from lpr_tpu_torch.models.lpsr import LPSR, LPSRConfig

    if not isinstance(lpsr, torch.nn.Module):
        lpsr = LPSR(lpsr, cfg or LPSRConfig()).to(resolve_device(device))
    x = torch.zeros((batch, hw[0], hw[1], 3), dtype=torch.float32,
                    device=_device(lpsr))
    export_fn(lpsr.eval(), (x,), path)


def export_detector(model, path: str, batch: int = 1,
                    hw=(1280, 1280)) -> None:
    """Export a loaded YOLO model's forward with the decode included and
    NMS excluded, (batch, H, W, 3) float32 -> (batch, N, 5+nc) float32, on
    the model's device.  An int8 model raises (its
    convolutions are the I1/I2 kernels)."""
    from lpr_tpu_torch.models.yolo import Detect
    x = torch.zeros((batch, hw[0], hw[1], 3), dtype=torch.float32,
                    device=_device(model))
    # Detect caches its grid/anchor tables by shape; entries made under the
    # trace hold its fake tensors, so the eager tables are put back after
    heads = [m for m in model.modules() if isinstance(m, Detect)]
    tables = [dict(h._tables) for h in heads]
    try:
        export_fn(_Predictions(model.eval()), (x,), path)
    finally:
        for h, t in zip(heads, tables):
            h._tables = t
