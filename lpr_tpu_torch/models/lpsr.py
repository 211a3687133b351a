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
from typing import Dict

import numpy as np
import torch

from lpr_tpu_torch.device import DeviceLike, resolve_device
from lpr_tpu_torch.ops import nn as tnn
from lpr_tpu_torch.weights import convert as cvt
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


def lpsr_from_torch(sd: Dict[str, np.ndarray],
                    cfg: LPSRConfig = LPSRConfig()) -> State:
    """The reference LPSR state dict (``best_model.pth``) as the port's flat
    state (``lpr_tpu.models.lpsr.lpsr_from_torch``): only the executed
    blocks are read, so the dead RDBs (``rdn.rdbs.{4,6}``), the CSAR
    copies at the odd indices and the autoencoder's duplicate ``GA`` keys
    are dropped."""
    out: State = {}

    def conv(key, name, bias=True):
        out[f"{key}/w"] = cvt.conv_w(sd[f"{name}.weight"])
        if bias and f"{name}.bias" in sd:
            out[f"{key}/b"] = cvt.vec(sd[f"{name}.bias"])

    def dconv(key, name):
        out[f"{key}/dw/w"] = cvt.dw_conv_w(sd[f"{name}.dConv.0.weight"])
        out[f"{key}/dw/b"] = cvt.vec(sd[f"{name}.dConv.0.bias"])
        conv(f"{key}/pw", f"{name}.dConv.1")

    conv("auto_encoder/conv_in", "auto_encoder.conv_in", bias=False)
    for key, name in (("enc0", "encoder.0"), ("enc1", "encoder.3"),
                      ("dec0", "decoder.0"), ("dec1", "decoder.3")):
        dconv(f"auto_encoder/{key}", f"auto_encoder.{name}")
    conv("auto_encoder/conv_out", "auto_encoder.conv_out", bias=False)
    conv("rdn/shallowF1", "rdn.shallowF1")
    conv("rdn/shallowF2", "rdn.shallowF2")
    c = "rdn.csar"
    conv("rdn/csar/conv_in0", f"{c}.conv_in.0")
    conv("rdn/csar/conv_in1", f"{c}.conv_in.2")
    for key, i in (("ca_fc1", 2), ("ca_fc2", 4)):
        out[f"rdn/csar/{key}/w"] = cvt.linear_w(sd[f"{c}.ca.block.{i}.weight"])
        out[f"rdn/csar/{key}/b"] = cvt.vec(sd[f"{c}.ca.block.{i}.bias"])
    conv("rdn/csar/sa_conv1", f"{c}.sa.block.0")
    conv("rdn/csar/sa_conv2", f"{c}.sa.block.2")
    conv("rdn/csar/conv_out", f"{c}.conv_out")
    for i in range(cfg.executed_rdbs):    # at even torch indices 0, 2, ...
        name = f"rdn.rdbs.{2 * i}"
        for j in range(cfg.num_layers):
            conv(f"rdn/rdbs/{i}/layers/{j}", f"{name}.layers.{j}.conv")
        conv(f"rdn/rdbs/{i}/lff", f"{name}.lff")
        out[f"rdn/rdbs/{i}/alpha"] = np.asarray(sd[f"{name}.alpha"],
                                                np.float32)
    conv("rdn/gff0", "rdn.gff.0")
    conv("rdn/gff1", "rdn.gff.1")
    conv("final_conv", "final_conv")
    return out


def lpsr_state(path: str, cfg: LPSRConfig = LPSRConfig()) -> State:
    """The flat LPSR state of a checkpoint: a flat npz such as
    ``checkpoints/lpsr_synth_glare/best_model.npz``, the reference's
    PyTorch state dict (``.pth``/``.pt``,
    :func:`lpr_tpu_torch.weights.torch_ckpt.load_state_dict`) or an
    exported ``.onnx`` graph, whose initializers carry the torch names
    (``lpr_tpu/models/lpsr.py:332-335``)."""
    if str(path).endswith(".npz"):
        return load_state(path)[0]
    if str(path).endswith((".pth", ".pt")):
        from lpr_tpu_torch.weights.torch_ckpt import load_state_dict

        return lpsr_from_torch(load_state_dict(path), cfg)
    if str(path).endswith(".onnx"):
        from lpr_tpu_torch.weights.onnx_import import load_onnx

        return lpsr_from_torch(load_onnx(path)["initializers"], cfg)
    raise ValueError(f"{path}: the port loads LPSR from .npz, .pth, .pt or "
                     f".onnx")


def load_lpsr(path: str, cfg: LPSRConfig = LPSRConfig(),
              device: DeviceLike = "cuda") -> LPSR:
    """LPSR on ``device`` from any checkpoint :func:`lpsr_state` reads."""
    dev = resolve_device(device)
    return LPSR(lpsr_state(path, cfg), cfg).to(dev).eval()
