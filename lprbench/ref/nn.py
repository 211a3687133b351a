"""The reference's arithmetic: NCHW convolutions and dense layers in
float32 (TF32 off), with two optional hooks that every layer of the
reference goes through.

- ``Arith.counter``: counts 2 x multiply-adds of each convolution and
  matrix product from its shapes (``lprbench/work/model_flops.py`` runs
  the reference on meta tensors with it).
- ``Arith.fp8``: the control of the correctness check: every convolution
  and matrix product takes its operands rounded to float8 e4m3 (weights per
  output channel, activations per tensor, each scaled to the format's
  largest value), the precision below the served bfloat16.

Plain PyTorch: nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
BN_EPS = 1e-3          # YOLOv5's BatchNorm2d eps
E4M3_MAX = 448.0


@dataclasses.dataclass
class Arith:
    """How the reference computes: ``fp8`` rounds the operands of every
    product to float8 e4m3; ``counter`` (a one-element list) sums their
    floating-point operations."""

    fp8: bool = False
    counter: Optional[list] = None

    def count(self, flops: int) -> None:
        if self.counter is not None:
            self.counter[0] += int(flops)


def _e4m3(x: Tensor, dims) -> Tensor:
    """x rounded to float8 e4m3 under a scale that maps its largest
    magnitude over ``dims`` (all where None) to the format's largest."""
    if dims is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=dims, keepdim=True)
    scale = E4M3_MAX / amax.clamp(min=1e-12)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def round_e4m3(x: Tensor) -> Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor."""
    return _e4m3(x, None)


def conv(ar: Arith, x: Tensor, w: Tensor, b: Optional[Tensor], stride=1,
         pad=0, groups: int = 1) -> Tensor:
    """NCHW x OIHW convolution with symmetric padding ``pad``."""
    if ar.counter is not None:
        n, _, h, wd = x.shape
        o, cig, kh, kw = w.shape
        ho = (h + 2 * pad - kh) // stride + 1
        wo = (wd + 2 * pad - kw) // stride + 1
        ar.count(2 * n * ho * wo * o * cig * kh * kw)
    if ar.fp8 and x.device.type != "meta":
        x, w = _e4m3(x, None), _e4m3(w, (1, 2, 3))
    return F.conv2d(x, w, b, stride=stride, padding=pad, groups=groups)


def linear(ar: Arith, x: Tensor, w: Tensor, b: Optional[Tensor] = None
           ) -> Tensor:
    """x (..., in) @ w (in, out) (+ b)."""
    ar.count(2 * x[..., 0].numel() * w.shape[0] * w.shape[1])
    if ar.fp8 and x.device.type != "meta":
        x, w = _e4m3(x, None), _e4m3(w, (0,))
    y = x @ w
    return y if b is None else y + b


def matmul(ar: Arith, a: Tensor, b: Tensor) -> Tensor:
    """Batched a (..., m, k) @ b (..., k, n)."""
    ar.count(2 * a.numel() * b.shape[-1])
    if ar.fp8 and a.device.type != "meta":
        a, b = _e4m3(a, None), _e4m3(b, None)
    return a @ b


def silu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(x)


def hwio(w: np.ndarray, device) -> Tensor:
    """An HWIO checkpoint weight as an OIHW float32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1))).to(device)


def vec(v, device) -> Tensor:
    return torch.from_numpy(np.asarray(v, np.float32).copy()).to(device)


def folded(state, prefix: str, device):
    """(OIHW weight, bias) of the conv at ``prefix`` with its inference
    batch norm folded in (eps 1e-3)."""
    w = np.asarray(state[f"{prefix}/w"], np.float64)
    b = state.get(f"{prefix}/b")
    b = np.zeros(w.shape[-1]) if b is None else np.asarray(b, np.float64)
    if f"{prefix}/bn/gamma" in state:
        scale = np.asarray(state[f"{prefix}/bn/gamma"], np.float64) / np.sqrt(
            np.asarray(state[f"{prefix}/bn/var"], np.float64) + BN_EPS)
        w = w * scale
        b = (b - np.asarray(state[f"{prefix}/bn/mean"], np.float64)) * scale \
            + np.asarray(state[f"{prefix}/bn/beta"], np.float64)
    return hwio(w, device), vec(b, device)
