"""Plain LPSR forward (NCHW, float32) from the repo's flat npz state: the
licence-plate super-resolution network of the reference implementation
(``inference/run.py``'s production configuration: 3 -> 1 channels, 32
features, growth 16, 4 blocks of 4 layers, expansion 4, autoencoder kernel
5), with its quirks: RDB0 -> CSAR -> RDB1 -> CSAR with one CSAR shared, the
channel attention applied as ``x_in * (x_in * mask)``, a learned residual
scale in each RDB.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lprbench.ref import nn as rn
from lprbench.ref.yolo import load_npz

Tensor = torch.Tensor
NUM_BLOCKS, NUM_LAYERS = 4, 4


class Lpsr:
    def __init__(self, path: str, device, ar: rn.Arith):
        self.state, _ = load_npz(path)
        self.dev, self.ar = device, ar
        self._w = {}

    def _conv(self, key: str, x: Tensor, groups: int = 1) -> Tensor:
        if key not in self._w:
            w = rn.hwio(self.state[f"{key}/w"], self.dev)
            b = self.state.get(f"{key}/b")
            self._w[key] = (w, None if b is None else rn.vec(b, self.dev))
        w, b = self._w[key]
        return rn.conv(self.ar, x, w, b, 1, w.shape[-1] // 2, groups)

    def _dconv(self, key: str, x: Tensor) -> Tensor:
        return self._conv(f"{key}/pw", self._conv(f"{key}/dw", x,
                                                  groups=x.shape[1]))

    def _vec(self, key: str) -> Tensor:
        if key not in self._w:
            self._w[key] = rn.vec(self.state[key], self.dev)
        return self._w[key]

    def _autoencoder(self, x: Tensor) -> Tensor:
        c_in = self._conv("auto_encoder/conv_in", x)
        y = F.relu(F.pixel_unshuffle(self._dconv("auto_encoder/enc0", c_in),
                                     2))
        y = F.relu(F.pixel_unshuffle(self._dconv("auto_encoder/enc1", y), 2))
        y = F.relu(F.pixel_shuffle(self._dconv("auto_encoder/dec0", y), 2))
        y = F.relu(F.pixel_shuffle(self._dconv("auto_encoder/dec1", y), 2))
        return self._conv("auto_encoder/conv_out", c_in + y)

    def _rdb(self, i: int, x: Tensor) -> Tensor:
        y = x
        for j in range(NUM_LAYERS):
            y = torch.cat([y, F.relu(self._conv(f"rdn/rdbs/{i}/layers/{j}",
                                                y))], 1)
        alpha = float(np.asarray(self.state[f"rdn/rdbs/{i}/alpha"]))
        return x + alpha * self._conv(f"rdn/rdbs/{i}/lff", y)

    def _csar(self, x: Tensor) -> Tensor:
        p = "rdn/csar"
        x_in = self._conv(f"{p}/conv_in1",
                          F.relu(self._conv(f"{p}/conv_in0", x)))
        ca = x_in.mean(dim=(2, 3))
        ca = rn.linear(self.ar, F.relu(rn.linear(
            self.ar, ca, self._vec(f"{p}/ca_fc1/w"),
            self._vec(f"{p}/ca_fc1/b"))), self._vec(f"{p}/ca_fc2/w"),
            self._vec(f"{p}/ca_fc2/b"))
        x_ca = x_in * torch.sigmoid(ca)[:, :, None, None]
        sa = torch.sigmoid(self._conv(f"{p}/sa_conv2", F.relu(
            self._conv(f"{p}/sa_conv1", x_in))))
        return x + self._conv(f"{p}/conv_out",
                              torch.cat([x_in * x_ca, x_in * sa], 1))

    def __call__(self, x: Tensor) -> Tensor:
        """x (N, 3, 32, 192) in [0, 1] -> (N, 1, 32, 192) in (0, 1)."""
        y = self._autoencoder(x)
        sfe1 = self._conv("rdn/shallowF1", y)
        y = self._conv("rdn/shallowF2", sfe1)
        feats = []
        for i in range(NUM_BLOCKS):
            y = self._rdb(i // 2, y) if i % 2 == 0 else self._csar(y)
            feats.append(y)
        y = self._conv("rdn/gff1", self._conv("rdn/gff0",
                                              torch.cat(feats, 1))) + sfe1
        return torch.sigmoid(self._conv("final_conv", y))
