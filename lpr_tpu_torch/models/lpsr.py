"""LPSR — license-plate super-resolution (counterpart of
``lpr_tpu/models/lpsr.py``): a PixelUnshuffle/PixelShuffle AutoEncoder
feeding an RDN of residual-dense blocks interleaved with CSAR
channel/spatial-attention blocks, global feature fusion and a sigmoid head.
32x192 RGB in, 1 channel out.

The reference's quirks are kept exactly, as in the JAX package:

- **Shared CSAR, half list**: the executed graph is RDB0 -> CSAR -> RDB2 ->
  CSAR with one shared CSAR applied twice (``LPSRConfig.executed_rdbs``
  distinct RDBs); the checkpoint holds only the executed blocks.
- **CA squaring**: the channel-attention branch is ``x_in**2 * mask``.
- RDBs carry a learned residual scale ``alpha``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lpr_tpu_torch.device import DeviceLike, resolve_device
from lpr_tpu_torch.ops import nn as tnn
from lpr_tpu_torch.weights.checkpoint import State, load_state

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LPSRConfig:
    """Production LPSR configuration (reference ``inference/run.py:124``)."""

    num_channels: int = 3
    num_features: int = 32
    growth_rate: int = 16
    num_blocks: int = 4
    num_layers: int = 4
    out_channels: int = 1
    expansion: int = 4
    ae_kernel: int = 5

    @property
    def executed_rdbs(self) -> int:
        """Distinct RDBs actually executed (shared-CSAR quirk):
        ceil(num_blocks / 2)."""
        return (self.num_blocks + 1) // 2


def _conv(state: State, prefix: str, groups: int = 1) -> tnn.Conv2d:
    return tnn.Conv2d.from_hwio(state[f"{prefix}/w"], state.get(f"{prefix}/b"),
                                groups=groups)


class DConv(torch.nn.Module):
    """Depthwise kxk + pointwise 1x1."""

    def __init__(self, state, prefix):
        super().__init__()
        c = state[f"{prefix}/dw/w"].shape[-1]
        self.dw = _conv(state, f"{prefix}/dw", groups=c)
        self.pw = _conv(state, f"{prefix}/pw")

    def forward(self, x):
        return self.pw(self.dw(x))


class AutoEncoder(torch.nn.Module):
    def __init__(self, state, prefix):
        super().__init__()
        self.conv_in = _conv(state, f"{prefix}/conv_in")
        self.enc0 = DConv(state, f"{prefix}/enc0")
        self.enc1 = DConv(state, f"{prefix}/enc1")
        self.dec0 = DConv(state, f"{prefix}/dec0")
        self.dec1 = DConv(state, f"{prefix}/dec1")
        self.conv_out = _conv(state, f"{prefix}/conv_out")

    def forward(self, x):
        _, h, w, _ = x.shape
        ph, pw = (4 - h % 4) % 4, (4 - w % 4) % 4
        if ph or pw:
            x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
        conv_in = self.conv_in(x)
        y = torch.relu(tnn.pixel_unshuffle(self.enc0(conv_in), 2))
        y = torch.relu(tnn.pixel_unshuffle(self.enc1(y), 2))
        y = torch.relu(tnn.pixel_shuffle(self.dec0(y), 2))
        y = torch.relu(tnn.pixel_shuffle(self.dec1(y), 2))
        return self.conv_out(conv_in + y)


class RDB(torch.nn.Module):
    """Residual dense block: dense 3x3 convs with channel concat, 1x1 local
    feature fusion, learned residual scale alpha."""

    def __init__(self, state, prefix, num_layers: int):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            [_conv(state, f"{prefix}/layers/{i}") for i in range(num_layers)])
        self.lff = _conv(state, f"{prefix}/lff")
        self.register_buffer("alpha", torch.from_numpy(
            np.asarray(state[f"{prefix}/alpha"], np.float32).reshape(())))

    def forward(self, x):
        y = x
        for conv in self.layers:
            y = torch.cat([y, torch.relu(conv(y))], -1)
        return x + self.alpha.to(x.dtype) * self.lff(y)


class CSAR(torch.nn.Module):
    """Channel & spatial attention residual block."""

    def __init__(self, state, prefix):
        super().__init__()
        for name in ("conv_in0", "conv_in1", "sa_conv1", "sa_conv2",
                     "conv_out"):
            setattr(self, name, _conv(state, f"{prefix}/{name}"))
        for name in ("ca_fc1", "ca_fc2"):
            for part in ("w", "b"):
                self.register_buffer(f"{name}_{part}", torch.from_numpy(
                    np.ascontiguousarray(state[f"{prefix}/{name}/{part}"])))

    def forward(self, x):
        x_in = self.conv_in1(torch.relu(self.conv_in0(x)))
        ca = x_in.mean(dim=(1, 2))
        ca = tnn.linear(torch.relu(tnn.linear(ca, self.ca_fc1_w,
                                              self.ca_fc1_b)),
                        self.ca_fc2_w, self.ca_fc2_b)
        x_ca = x_in * torch.sigmoid(ca)[:, None, None, :]
        sa = torch.sigmoid(self.sa_conv2(torch.relu(self.sa_conv1(x_in))))
        return x + self.conv_out(torch.cat([x_in * x_ca, x_in * sa], -1))


class LPSR(torch.nn.Module):
    """The LPSR forward (``lpr_tpu.models.lpsr.lpsr_apply``): x (N, H, W, 3)
    in [0, 1] -> (N, H, W, out_channels) in (0, 1)."""

    def __init__(self, state: State, cfg: LPSRConfig = LPSRConfig()):
        super().__init__()
        self.cfg = cfg
        self.auto_encoder = AutoEncoder(state, "auto_encoder")
        self.shallowF1 = _conv(state, "rdn/shallowF1")
        self.shallowF2 = _conv(state, "rdn/shallowF2")
        self.csar = CSAR(state, "rdn/csar")
        self.rdbs = torch.nn.ModuleList([
            RDB(state, f"rdn/rdbs/{i}", cfg.num_layers)
            for i in range(cfg.executed_rdbs)])
        self.gff0 = _conv(state, "rdn/gff0")
        self.gff1 = _conv(state, "rdn/gff1")
        self.final_conv = _conv(state, "final_conv")

    def forward(self, x: Tensor) -> Tensor:
        y = self.auto_encoder(x)
        sfe1 = self.shallowF1(y)
        y = self.shallowF2(sfe1)
        local_features = []
        for i in range(self.cfg.num_blocks):
            y = self.rdbs[i // 2](y) if i % 2 == 0 else self.csar(y)
            local_features.append(y)
        y = self.gff1(self.gff0(torch.cat(local_features, -1))) + sfe1
        return torch.sigmoid(self.final_conv(y))


def load_lpsr(path: str, cfg: LPSRConfig = LPSRConfig(),
              device: DeviceLike = "cuda") -> LPSR:
    """LPSR from a flat npz checkpoint such as
    ``checkpoints/lpsr_synth_glare/best_model.npz``."""
    dev = resolve_device(device)
    state, _ = load_state(path)
    return LPSR(state, cfg).to(dev).eval()
