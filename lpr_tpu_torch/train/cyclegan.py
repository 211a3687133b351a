"""CycleGAN trainer, the HR <-> LR degradation GAN (counterpart of
``lpr_tpu/train/cyclegan.py``, reference ``train/cyclegans.py:24-196``).

- two generators (A -> B, B -> A) and two spectral-norm PatchGAN
  discriminators, normal(0, 0.02) init;
- generator losses: identity L1 x5 both ways, LSGAN MSE x``lambda_gan``,
  cycle L1 x10 (A) and x20 (B), the reference's asymmetric weights;
- Adam(lr 2e-4, betas (0.5, 0.999)) for the generators together and for
  each discriminator;
- each discriminator on fakes from an :class:`ImagePool` of 50 (seeds 1
  and 2), its loss x0.5.

The weights are flat states of leaf tensors (HWIO); the generators run as
:class:`~lpr_tpu_torch.models.cyclegan.Generator` modules through
``torch.func.functional_call``, the discriminators through the functional
:func:`~lpr_tpu_torch.models.cyclegan.discriminator_apply`.  The power
iteration's ``u`` vectors are carried in the discriminator states but not
optimized: each discriminator step replaces them with the vectors of its
real pass (detached), and its fake pass runs on those, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.func import functional_call

from lpr_tpu_torch.data.image_pool import ImagePool
from lpr_tpu_torch.device import DeviceLike, resolve_device
from lpr_tpu_torch.models.cyclegan import (Generator, GeneratorConfig,
                                           discriminator_apply,
                                           discriminator_init,
                                           generator_init)
from lpr_tpu_torch.ops import nn as tnn
from lpr_tpu_torch.train.lpsr import as_device, leaves

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CycleGANConfig:
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    lambda_identity: float = 5.0
    lambda_gan: float = 2.0
    lambda_cycle_a: float = 10.0
    lambda_cycle_b: float = 20.0
    pool_size: int = 50


def _l1(a: Tensor, b: Tensor) -> Tensor:
    return (a - b).abs().mean()


def _mse_to(a: Tensor, target: float) -> Tensor:
    return ((a - target) ** 2).mean()


def _is_u(key: str) -> bool:
    return key.endswith("/u")


class CycleGANTrainer:
    """The trainer; its state holds ``g`` ({"ab", "ba"} generator
    leaves), ``d`` ({"a", "b"} discriminator states: leaf ``w``/``b``,
    plain ``u``) and the optimizers ``g_opt``, ``da_opt``, ``db_opt``."""

    def __init__(self, cfg: CycleGANConfig = CycleGANConfig(),
                 gen_cfg: GeneratorConfig = GeneratorConfig(),
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.gen_cfg = gen_cfg
        self.device = resolve_device(device)
        self.pool_a = ImagePool(cfg.pool_size, seed=1)
        self.pool_b = ImagePool(cfg.pool_size, seed=2)
        self.gens: Dict[str, Generator] = {}

    # ------------------------------------------------------------------
    def init(self, g: torch.Generator) -> Dict[str, Any]:
        """Fresh weights drawn from ``g`` (:func:`generator_init`,
        :func:`discriminator_init`)."""
        gc = self.gen_cfg
        return self.state_from(
            {"ab": generator_init(g, gc), "ba": generator_init(g, gc)},
            {"a": discriminator_init(g, gc.in_channels),
             "b": discriminator_init(g, gc.out_channels)})

    def state_from(self, g_states: Dict, d_states: Dict) -> Dict[str, Any]:
        """The trainer's state from flat generator states {"ab", "ba"} and
        discriminator states {"a", "b"} (numpy or tensors)."""
        dev = self.device
        g = {k: leaves(s, dev) for k, s in g_states.items()}
        self.gens = {k: Generator({n: t.detach().cpu().numpy()
                                   for n, t in s.items()}).to(dev)
                     for k, s in g.items()}
        d = {}
        for k, s in d_states.items():
            d[k] = leaves({n: v for n, v in s.items() if not _is_u(n)}, dev)
            d[k].update({n: torch.as_tensor(v, dtype=torch.float32,
                                            device=dev).clone()
                         for n, v in s.items() if _is_u(n)})

        def adam(tensors):
            return torch.optim.Adam(tensors, lr=self.cfg.lr,
                                    betas=(self.cfg.beta1, self.cfg.beta2),
                                    eps=1e-8)

        def trained(s):
            return [v for n, v in s.items() if not _is_u(n)]

        return {"g": g, "d": d,
                "g_opt": adam(list(g["ab"].values())
                              + list(g["ba"].values())),
                "da_opt": adam(trained(d["a"])),
                "db_opt": adam(trained(d["b"]))}

    def generate(self, state: Dict, which: str, x: Tensor) -> Tensor:
        """Generator ``which`` ("ab" or "ba") on x (N, H, W, C) in
        [-1, 1]."""
        gen = self.gens[which]
        return functional_call(
            gen, tnn.state_to_buffers(gen, state["g"][which]), (x,))

    def g_loss(self, state: Dict, real_a: Tensor, real_b: Tensor):
        """(total, aux) of the generator step; the discriminators enter
        as constants."""
        cfg = self.cfg
        d = {k: {n: v.detach() for n, v in s.items()}
             for k, s in state["d"].items()}

        def gen(which, x):
            return self.generate(state, which, x)

        loss_id = (_l1(gen("ab", real_b), real_b)
                   + _l1(gen("ba", real_a), real_a)) * cfg.lambda_identity
        fake_b = gen("ab", real_a)
        fake_a = gen("ba", real_b)
        pred_fb, _ = discriminator_apply(d["b"], fake_b)
        pred_fa, _ = discriminator_apply(d["a"], fake_a)
        loss_gan = (_mse_to(pred_fb, 1.0)
                    + _mse_to(pred_fa, 1.0)) * cfg.lambda_gan
        loss_cyc = (_l1(gen("ba", fake_b), real_a) * cfg.lambda_cycle_a
                    + _l1(gen("ab", fake_a), real_b) * cfg.lambda_cycle_b)
        total = loss_id + loss_gan + loss_cyc
        return total, {"fake_a": fake_a.detach(), "fake_b": fake_b.detach(),
                       "id": loss_id.detach(), "gan": loss_gan.detach(),
                       "cyc": loss_cyc.detach()}

    def g_step(self, state: Dict, real_a: Tensor, real_b: Tensor):
        """One generator update; returns (loss, aux)."""
        loss, aux = self.g_loss(state, real_a, real_b)
        state["g_opt"].zero_grad(set_to_none=True)
        loss.backward()
        state["g_opt"].step()
        return loss.detach(), aux

    def d_step(self, state: Dict, which: str, real: Tensor,
               fake: Tensor) -> Tensor:
        """One update of discriminator ``which`` ("a" or "b"): LSGAN on
        the real batch (whose pass advances the power iteration) and the
        pooled fakes (on the advanced ``u``); then the state carries the
        new ``u``."""
        d = state["d"][which]
        pred_r, d_new = discriminator_apply(d, real, update_sn=True)
        pred_f, _ = discriminator_apply(d_new, fake.detach())
        loss = (_mse_to(pred_r, 1.0) + _mse_to(pred_f, 0.0)) * 0.5
        opt = state[f"d{which}_opt"]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        with torch.no_grad():
            for n in d:
                if _is_u(n):
                    d[n].copy_(d_new[n])
        return loss.detach()

    def step(self, state: Dict[str, Any], real_a, real_b):
        """One iteration: the generators, then D_A and D_B on pooled fakes
        (reference :78-141).  Returns (state, metrics as floats)."""
        real_a = as_device(real_a, self.device)
        real_b = as_device(real_b, self.device)
        g_loss, aux = self.g_step(state, real_a, real_b)
        fake_a = self.pool_a.query(aux["fake_a"])
        fake_b = self.pool_b.query(aux["fake_b"])
        da_loss = self.d_step(state, "a", real_a, fake_a)
        db_loss = self.d_step(state, "b", real_b, fake_b)
        metrics = {"g_loss": float(g_loss), "d_a_loss": float(da_loss),
                   "d_b_loss": float(db_loss), "id": float(aux["id"]),
                   "gan": float(aux["gan"]), "cyc": float(aux["cyc"])}
        return state, metrics
