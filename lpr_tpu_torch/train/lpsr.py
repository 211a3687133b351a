"""LPSR trainer: MSE, Adam and a plateau learning rate on validation PSNR
(counterpart of ``lpr_tpu/train/lpsr.py``, reference ``train/lpsr.py:97-201``).

The trainer holds the flat float32 state (the key layout of
:mod:`lpr_tpu_torch.weights.checkpoint`, HWIO convs) as leaf tensors with
``requires_grad``, the counterpart of the JAX params pytree, and runs the
serving :class:`~lpr_tpu_torch.models.lpsr.LPSR` module through
``torch.func.functional_call`` with those leaves in its buffers' places
(:func:`lpr_tpu_torch.ops.nn.state_to_buffers`).  The forward and backward
go through autograd on the plain module, as the JAX step differentiates
``lpsr_apply``: no kernel has a backward pass.

:meth:`LPSRTrainer.validate` packs the current weights once and runs the
evaluator's route: K2's float32 instance (``lpsr_fused``) for the
production configuration (its plain version on the CPU), ``LPSR.forward``
for any other.

With a ``mesh`` (:func:`lpr_tpu_torch.parallel.mesh.make_mesh`: one local
device, and the process group of the other ranks) each rank steps on its
local batch and the gradients are averaged over the ranks in one flat
all-reduce a step, with the loss, before Adam: the step of one process on
the global batch (equal local batches).  :meth:`LPSRTrainer.validate`
gathers every rank's per-image PSNRs, so every rank returns the same mean
and takes the same plateau decision.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from lpr_tpu_torch.device import DeviceLike, resolve_device
from lpr_tpu_torch.models.lpsr import LPSR, LPSRConfig, lpsr_init
from lpr_tpu_torch.ops import nn as tnn
from lpr_tpu_torch.parallel import collectives

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LPSRTrainConfig:
    lr: float = 1e-3              # reference train/lpsr.py:214
    plateau_factor: float = 0.5   # ReduceLROnPlateau(max, x0.5, patience 10)
    plateau_patience: int = 10
    min_lr: float = 1e-6
    weight_dtype: torch.dtype = torch.float32    # the state's leaves
    compute_dtype: torch.dtype = torch.float32   # the forward's input


def psnr(pred: Tensor, target: Tensor, max_val: float = 1.0) -> Tensor:
    """Per-image PSNR over the trailing dimensions, (B,)."""
    dims = tuple(range(1, pred.dim()))
    mse = ((pred - target) ** 2).mean(dim=dims)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp_min(mse, 1e-12))


def as_device(x, device: torch.device) -> Tensor:
    """A numpy batch or a tensor as a float32 tensor on ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device, torch.float32)


def leaves(state, device, dtype=torch.float32) -> Dict[str, Tensor]:
    """A flat state (numpy or tensors) as leaf tensors on ``device`` that
    require gradients."""
    return {k: (v.detach() if torch.is_tensor(v)
                else torch.from_numpy(np.array(v, np.float32))
                ).to(device, dtype).clone().requires_grad_(True)
            for k, v in state.items()}


def mesh_group(mesh):
    """The process group of a trainer's mesh; a mesh of more than one
    local device raises (one process drives one device)."""
    if mesh.size != 1:
        raise ValueError(f"a trainer runs on one device a process, not "
                         f"{mesh.size}: launch one process a device "
                         f"(WORLD_SIZE, RANK, COORDINATOR_ADDRESS)")
    return mesh.group


class LPSRTrainer:
    """The trainer; its state is a dict of ``params`` (the flat leaves),
    ``opt`` (``torch.optim.Adam`` over them), ``lr_scale``, ``best_psnr``
    and ``bad_epochs``, as the JAX trainer's."""

    def __init__(self, cfg: LPSRTrainConfig = LPSRTrainConfig(),
                 lpsr_cfg: LPSRConfig = LPSRConfig(),
                 device: DeviceLike = "cuda", mesh=None):
        """``mesh``: data parallelism over its process group, on its one
        device (which ``device`` then does not name)."""
        self.cfg = cfg
        self.lpsr_cfg = lpsr_cfg
        self.mesh = mesh
        self.group = None if mesh is None else mesh_group(mesh)
        self.device = (resolve_device(device) if mesh is None
                       else mesh.devices[0])
        self.model: Optional[LPSR] = None

    # ------------------------------------------------------------------
    def init(self, g: Optional[torch.Generator] = None,
             params=None) -> Dict[str, Any]:
        """Fresh weights from ``g`` (:func:`lpsr_init`; default a generator
        on the trainer's device seeded 0) or ``params``, a flat state to
        start from."""
        if params is None:
            if g is None:
                g = torch.Generator(device=self.device).manual_seed(0)
            params = lpsr_init(g, self.lpsr_cfg)
        p = leaves(params, self.device, self.cfg.weight_dtype)
        self.model = LPSR({k: v.detach().float().cpu().numpy()
                           for k, v in p.items()},
                          self.lpsr_cfg).to(self.device)
        # Adam(b1 0.9, b2 0.999, eps 1e-8); the group's lr is set to
        # lr * lr_scale before each step (JAX: scale_by_adam * -lr * scale)
        opt = torch.optim.Adam(list(p.values()), lr=self.cfg.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        return {"params": p, "opt": opt, "lr_scale": 1.0,
                "best_psnr": -math.inf, "bad_epochs": 0}

    def forward(self, params: Dict[str, Tensor], x: Tensor) -> Tensor:
        """The LPSR forward with the leaves ``params`` as its weights."""
        return functional_call(self.model,
                               tnn.state_to_buffers(self.model, params),
                               (x.to(self.cfg.compute_dtype),))

    def loss(self, params: Dict[str, Tensor], lr_img: Tensor,
             hr_img: Tensor) -> Tensor:
        pred = self.forward(params, lr_img)
        return ((pred.float() - hr_img) ** 2).mean()

    def step(self, state: Dict, lr_img, hr_img) -> Tuple[Dict, Tensor]:
        """One Adam step on a batch; returns (state, the loss before the
        update, a 0-d tensor on the device)."""
        lr_img = as_device(lr_img, self.device)
        hr_img = as_device(hr_img, self.device)
        opt = state["opt"]
        for group in opt.param_groups:
            group["lr"] = self.cfg.lr * state["lr_scale"]
        loss = self.loss(state["params"], lr_img, hr_img)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if self.group is not None:
            ps = [p for p in state["params"].values() if p.grad is not None]
            got = collectives.average([p.grad for p in ps] + [loss],
                                      self.group)
            for p, g in zip(ps, got):
                p.grad = g
            loss = got[-1]
        opt.step()
        return state, loss

    @torch.no_grad()
    def validate(self, state: Dict, batches: Iterable) -> float:
        """Mean per-image PSNR of the clipped prediction over ``batches``.
        The production configuration in float32 runs K2's float32 instance
        on the weights packed once here; any other runs ``LPSR.forward``."""
        from lpr_tpu_torch.kernels.lpsr import (lpsr_fused,
                                                lpsr_kernel_takes, lpsr_pack)

        tnn.load_state_into(self.model, state["params"])
        packed = (lpsr_pack(self.model)
                  if lpsr_kernel_takes(self.lpsr_cfg)
                  and self.cfg.compute_dtype == torch.float32 else None)
        vals = []
        for lr_img, hr_img in batches:
            x = as_device(lr_img, self.device)
            hr = as_device(hr_img, self.device)
            pred = (lpsr_fused(x.contiguous(), packed) if packed is not None
                    else self.model(x.to(self.cfg.compute_dtype)))
            vals.append(psnr(torch.clamp(pred.float(), 0.0, 1.0), hr))
        if not vals:
            return float("nan")
        return float(collectives.all_gather_cat(torch.cat(vals),
                                                self.group).mean())

    def plateau_update(self, state: Dict, val_psnr: float) -> Dict:
        """ReduceLROnPlateau(mode=max): after more than ``plateau_patience``
        epochs without a new best, scale the rate by ``plateau_factor``
        (not below ``min_lr``)."""
        if val_psnr > state["best_psnr"]:
            return dict(state, best_psnr=val_psnr, bad_epochs=0)
        bad = state["bad_epochs"] + 1
        if bad > self.cfg.plateau_patience:
            new_scale = max(state["lr_scale"] * self.cfg.plateau_factor,
                            self.cfg.min_lr / self.cfg.lr)
            return dict(state, bad_epochs=0, lr_scale=new_scale)
        return dict(state, bad_epochs=bad)

    def fit(self, train_batches_fn, val_batches_fn, epochs: int,
            ckpt_dir: Optional[str] = None, log_every: int = 50,
            logger=print, init_params=None) -> Dict:
        """Per epoch: train, validation PSNR, the plateau rule, and
        ``last_model.npz`` / ``best_model.npz`` in ``ckpt_dir``.
        ``init_params`` (a flat state) warm-starts."""
        from lpr_tpu_torch.weights.checkpoint import save_state

        state = self.init(params=init_params)
        best = -math.inf
        for epoch in range(epochs):
            losses = []
            for i, (lr_img, hr_img) in enumerate(train_batches_fn()):
                state, loss = self.step(state, lr_img, hr_img)
                losses.append(float(loss))
                if log_every and i % log_every == 0:
                    logger(f"epoch {epoch} it {i} loss {losses[-1]:.5f}")
            val_psnr = self.validate(state, val_batches_fn())
            state = self.plateau_update(state, val_psnr)
            logger(f"epoch {epoch}: loss {np.mean(losses):.5f} val PSNR "
                   f"{val_psnr:.3f} lr_scale {state['lr_scale']:.4f}")
            if ckpt_dir:
                save_state(f"{ckpt_dir}/last_model.npz", state["params"])
                if val_psnr > best:
                    best = val_psnr
                    save_state(f"{ckpt_dir}/best_model.npz",
                               state["params"])
        return state
