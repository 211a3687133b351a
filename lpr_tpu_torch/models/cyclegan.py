"""CycleGAN generator and discriminator forwards for HR -> LR degradation
synthesis (counterpart of ``lpr_tpu/models/cyclegan.py``), NHWC.

- :class:`Generator`: reflection pad + 7x7 conv, two stride-2 downsamples,
  InstanceNorm ResNet blocks, two nearest-upsample + conv stages, 7x7 conv,
  tanh; built from the flat state of ``checkpoints/cyclegan_real_g.npz`` or
  ``demo_cyclegan_g.npz`` (stored in fp16, cast to float32 at load as the
  JAX loader casts them into its float32 template).
- :func:`discriminator_apply`: the PatchGAN of 4x4 convs with spectral
  norm, one power-iteration step a forward, returning the new ``u``
  vectors as the JAX function returns its new params.  Its training step
  belongs with the trainers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from lpr_tpu_torch.device import DeviceLike, resolve_device
from lpr_tpu_torch.ops import nn as tnn
from lpr_tpu_torch.weights import convert as cvt
from lpr_tpu_torch.weights.checkpoint import State, load_state

Tensor = torch.Tensor


def _conv(state: State, prefix: str, **kw) -> tnn.Conv2d:
    return tnn.Conv2d.from_hwio(state[f"{prefix}/w"], state.get(f"{prefix}/b"),
                                **kw)


class _ResnetBlock(torch.nn.Module):
    """Reflection-padded InstanceNorm residual block."""

    def __init__(self, state: State, prefix: str):
        super().__init__()
        self.c0 = _conv(state, f"{prefix}/c0", padding=0)
        self.c1 = _conv(state, f"{prefix}/c1", padding=0)

    def forward(self, x):
        y = tnn.relu(tnn.instance_norm(self.c0(tnn.reflect_pad2d(x, 1))))
        return x + tnn.instance_norm(self.c1(tnn.reflect_pad2d(y, 1)))


class Generator(torch.nn.Module):
    """``generator_apply``: x (N, H, W, C) in [-1, 1] -> (N, H, W, C) in
    [-1, 1]; H and W multiples of 4."""

    def __init__(self, state: State):
        super().__init__()
        n_blocks = len({k.split("/")[1] for k in state
                        if k.startswith("blocks/")})
        self.head = _conv(state, "head", padding=0)
        self.down0 = _conv(state, "down0", stride=2, padding=1)
        self.down1 = _conv(state, "down1", stride=2, padding=1)
        self.blocks = torch.nn.ModuleList(
            [_ResnetBlock(state, f"blocks/{i}") for i in range(n_blocks)])
        self.up0 = _conv(state, "up0", padding=1)
        self.up1 = _conv(state, "up1", padding=1)
        self.tail = _conv(state, "tail", padding=0)

    def forward(self, x: Tensor) -> Tensor:
        def norm_relu(y):
            return tnn.relu(tnn.instance_norm(y))

        y = norm_relu(self.head(tnn.reflect_pad2d(x, 3)))
        y = norm_relu(self.down0(y))
        y = norm_relu(self.down1(y))
        for block in self.blocks:
            y = block(y)
        y = norm_relu(self.up0(tnn.upsample_nearest(y, 2)))
        y = norm_relu(self.up1(tnn.upsample_nearest(y, 2)))
        return torch.tanh(self.tail(tnn.reflect_pad2d(y, 3)))


def generator_apply(gen: Generator, x: Tensor) -> Tensor:
    """The generator forward (``lpr_tpu.models.cyclegan.generator_apply``)."""
    return gen(x)


def load_generator(path: str, device: DeviceLike = "cuda") -> Generator:
    """A generator from a flat npz checkpoint (fp16 values cast to
    float32), or from the reference Generator's PyTorch state dict
    (``.pth``/``.pt``, through :func:`generator_from_torch`)."""
    dev = resolve_device(device)
    if str(path).endswith((".pth", ".pt")):
        from lpr_tpu_torch.weights.torch_ckpt import load_state_dict

        state = generator_from_torch(load_state_dict(path))
    else:
        state, _ = load_state(path)
    return Generator(state).to(dev).eval()


def generator_from_torch(sd: Dict[str, np.ndarray]) -> State:
    """The reference Generator's state dict (``model.{i}`` Sequential
    indices: 1 head, 4 down0, 7 down1, 10..18 blocks, 20 up0, 23 up1, 26
    tail) as the port's flat state."""
    out: State = {}

    def conv(key, name):
        out[f"{key}/w"] = cvt.conv_w(sd[f"{name}.weight"])
        out[f"{key}/b"] = cvt.vec(sd[f"{name}.bias"])

    for key, i in (("head", 1), ("down0", 4), ("down1", 7), ("up0", 20),
                   ("up1", 23), ("tail", 26)):
        conv(key, f"model.{i}")
    for j, i in enumerate(range(10, 19)):
        conv(f"blocks/{j}/c0", f"model.{i}.conv_block.1")
        conv(f"blocks/{j}/c1", f"model.{i}.conv_block.5")
    return out


def _spectral_normalize(w: Tensor, u: Tensor) -> Tuple[Tensor, Tensor]:
    """One power-iteration step on the HWIO weight flattened to (cout,
    rest), torch ``spectral_norm`` semantics: (w / sigma, new u)."""
    cout = w.shape[-1]
    wm = w.reshape(-1, cout).T
    v = wm.T @ u
    v = v / torch.clamp_min(torch.linalg.norm(v), 1e-12)
    u = wm @ v
    u = u / torch.clamp_min(torch.linalg.norm(u), 1e-12)
    sigma = u @ (wm @ v)
    return w / sigma, u


def discriminator_apply(p: Dict[str, Tensor], x: Tensor,
                        update_sn: bool = False
                        ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """PatchGAN forward (``lpr_tpu.models.cyclegan.discriminator_apply``).
    ``p`` is the flat state (``convs/{i}/w`` HWIO, ``convs/{i}/u``,
    ``convs/0/b``, ``final/w``, ``final/b``) as tensors.  Returns (logits
    map, new state): with ``update_sn`` the new state carries the updated
    power-iteration vectors."""
    new_p = dict(p)
    y = x
    n = len({k.split("/")[1] for k in p if k.startswith("convs/")})
    for i in range(n):
        w, u = _spectral_normalize(p[f"convs/{i}/w"], p[f"convs/{i}/u"])
        if update_sn:
            new_p[f"convs/{i}/u"] = u
        y = tnn.conv2d(y, w.permute(3, 2, 0, 1), p.get(f"convs/{i}/b"),
                       stride=2 if i < 3 else 1, padding=1)
        if i > 0:
            y = tnn.instance_norm(y)
        y = tnn.leaky_relu(y, 0.2)
    y = tnn.conv2d(y, p["final/w"].permute(3, 2, 0, 1), p["final/b"],
                   stride=1, padding=1)
    return y, new_p
