"""Experimental LPSR architecture variants (counterpart of
``lpr_tpu/models/lpsr_variants.py``, the reference's experiments/ver01-03),
built on the port's LPSR blocks (:mod:`lpr_tpu_torch.models.lpsr`).

- :class:`Ver01`: plain RDN -> conv channel attention -> PixelShuffle
  upscale -> 3x3 conv (linear output).
- :class:`Ver02`: an input 3x3 conv, ver01, sigmoid output.
- :class:`Ver03`: one IFE conv, a stack of CSAR blocks, upscale, 3x3 conv,
  sigmoid.

Each takes the flat state of the JAX ``ver0N_init`` pytree
(:func:`lpr_tpu_torch.weights.checkpoint.params_from_jax`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from lpr_tpu_torch.models.lpsr import CSAR, RDB, _conv
from lpr_tpu_torch.ops import nn as tnn
from lpr_tpu_torch.weights.checkpoint import State


@dataclasses.dataclass(frozen=True)
class VariantConfig:
    num_channels: int = 3
    num_features: int = 32
    growth_rate: int = 16
    num_blocks: int = 4
    num_layers: int = 4
    scale_factor: int = 2


def _stages(cfg: VariantConfig) -> int:
    return int(math.log2(cfg.scale_factor)) if cfg.scale_factor > 1 else 0


class _Upscale(torch.nn.Module):
    """Conv(c -> 4c) + ReLU + PixelShuffle(2), log2(scale) times."""

    def __init__(self, state: State, prefix: str, stages: int):
        super().__init__()
        self.convs = torch.nn.ModuleList(
            [_conv(state, f"{prefix}/{i}") for i in range(stages)])

    def forward(self, x):
        for conv in self.convs:
            x = tnn.pixel_shuffle(tnn.relu(conv(x)), 2)
        return x


class _RDNPlain(torch.nn.Module):
    """Plain RDN (no CSAR interleave): 7x7 + 3x3 shallow features,
    ``num_blocks`` RDBs, global feature fusion."""

    def __init__(self, state: State, prefix: str, cfg: VariantConfig):
        super().__init__()
        self.sf1 = _conv(state, f"{prefix}/sf1")
        self.sf2 = _conv(state, f"{prefix}/sf2")
        self.rdbs = torch.nn.ModuleList(
            [RDB(state, f"{prefix}/rdbs/{i}", cfg.num_layers)
             for i in range(cfg.num_blocks)])
        self.gff0 = _conv(state, f"{prefix}/gff0")
        self.gff1 = _conv(state, f"{prefix}/gff1")

    def forward(self, x):
        sfe1 = self.sf1(x)
        y = self.sf2(sfe1)
        feats = []
        for rdb in self.rdbs:
            y = rdb(y)
            feats.append(y)
        return self.gff1(self.gff0(torch.cat(feats, -1))) + sfe1


class _CAConv(torch.nn.Module):
    """Conv channel attention: GAP -> 1x1 -> ReLU -> 1x1 -> sigmoid (the
    mask only)."""

    def __init__(self, state: State, prefix: str):
        super().__init__()
        self.c1 = _conv(state, f"{prefix}/c1")
        self.c2 = _conv(state, f"{prefix}/c2")

    def forward(self, x):
        g = x.mean(dim=(1, 2), keepdim=True)
        return torch.sigmoid(self.c2(tnn.relu(self.c1(g))))


class Ver01(torch.nn.Module):
    """RDN -> CA -> upscale -> conv (linear output)."""

    def __init__(self, state: State, cfg: VariantConfig = VariantConfig()):
        super().__init__()
        self.rdn = _RDNPlain(state, "rdn", cfg)
        self.ca = _CAConv(state, "ca")
        self.up = _Upscale(state, "up", _stages(cfg))
        self.final = _conv(state, "final")

    def forward(self, x):
        y = self.rdn(x)
        y = y * self.ca(y)
        return self.final(self.up(y))


class Ver02(torch.nn.Module):
    """Input conv + ver01 + sigmoid output."""

    def __init__(self, state: State, cfg: VariantConfig = VariantConfig()):
        super().__init__()
        self.conv_in = _conv(state, "conv_in")
        self.body = Ver01(state, cfg)

    def forward(self, x):
        return torch.sigmoid(self.body(self.conv_in(x)))


class Ver03(torch.nn.Module):
    """IFE conv -> CSAR stack -> upscale -> conv -> sigmoid."""

    def __init__(self, state: State, cfg: VariantConfig = VariantConfig()):
        super().__init__()
        self.ife = _conv(state, "ife")
        self.csars = torch.nn.ModuleList(
            [CSAR(state, f"csars/{i}") for i in range(cfg.num_blocks)])
        self.up = _Upscale(state, "up", _stages(cfg))
        self.final = _conv(state, "final")

    def forward(self, x):
        y = self.ife(x)
        for csar in self.csars:
            y = csar(y)
        return torch.sigmoid(self.final(self.up(y)))
