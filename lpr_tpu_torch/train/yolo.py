"""YOLO detector trainer (counterpart of ``lpr_tpu/train/yolo.py``,
reference ``yolov5/train.py:65-643``): SGD with Nesterov momentum in three
groups (conv and Linear weights decayed, biases on the warm-up bias rate,
batch norm and the rest neither), linear or one-cycle learning rate,
per-step warm-up of the rate, the bias rate and the momentum, the EMA of
the weights with its ramped decay, gradient accumulation over
micro-batches, the non-finite guard, early stopping, and validation mAP.

The trainer holds the flat unfolded state (:mod:`lpr_tpu_torch.models
.yolo_train`'s keys) as leaf tensors, as the enhancement trainers do, and
runs the detector's training route (:func:`~lpr_tpu_torch.models
.yolo_train.train_forward`: batch statistics, new running statistics)
under autograd; no kernel has a backward pass.  :meth:`YoloTrainer.step`
updates the state's tensors in place.  A step whose loss or any gradient
is not finite changes nothing but the step counter; finding that out reads
one flag back from the device, once a step.

:func:`validate_map` loads the EMA weights into the serving
:class:`~lpr_tpu_torch.models.yolo.YoloModel` (batch norm folded), decodes
and runs :func:`~lpr_tpu_torch.ops.nms.nms_batched` per class
(``agnostic=False``, as the JAX validation), in float32.

With a ``mesh`` (one local device and the process group of the other
ranks) the step is JAX's sharded step over the global batch: the batch
statistics and the loss's positive count are the global batch's
(``train_forward`` and ``yolo_loss`` with the group), micro-batch j of a
step is the union of every rank's micro-batch j, and the gradients, the
loss and its components are averaged over the ranks in one flat
all-reduce a step.  The non-finite guard reads its flag after that
all-reduce, so every rank takes the same branch.  :func:`fit_yolo`
validates the whole set on every rank, as JAX's does, so early stopping
agrees across ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from lpr_tpu_torch.device import DeviceLike, resolve_device
from lpr_tpu_torch.models.yolo import YoloModel
from lpr_tpu_torch.models.yolo_train import train_forward, yolo_init
from lpr_tpu_torch.parallel import collectives
from lpr_tpu_torch.train.lpsr import as_device, mesh_group
from lpr_tpu_torch.train.yolo_loss import YoloLossConfig, yolo_loss
from lpr_tpu_torch.utils.guards import all_finite

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class YoloTrainConfig:
    lr0: float = 0.01
    lrf: float = 0.01            # final OneCycle fraction
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    cos_lr: bool = False
    epochs: int = 300
    nominal_batch: int = 64
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    compute_dtype: torch.dtype = torch.float32


def _is_conv_weight(key: str) -> bool:
    """Conv and Linear kernels (``.../w`` outside a batch norm) are
    decayed; biases and batch norm are not (train.py:156-167)."""
    parts = key.split("/")
    return parts[-1] == "w" and "bn" not in parts[:-1]


def _is_bias(key: str) -> bool:
    return key.split("/")[-1] in ("b", "beta")


def _is_running_stat(key: str) -> bool:
    parts = key.split("/")
    return len(parts) >= 2 and parts[-2] == "bn" and parts[-1] in ("mean",
                                                                    "var")


def lr_schedule(cfg: YoloTrainConfig, epoch_f: float) -> float:
    """One-cycle cosine or linear decay over epochs (train.py:178-183)."""
    x = min(max(epoch_f / cfg.epochs, 0.0), 1.0)
    if cfg.cos_lr:
        return ((1 - x) * (1.0 - cfg.lrf) * 0.5 * (1 + math.cos(math.pi * x))
                + cfg.lrf)
    return (1.0 - x) * (1.0 - cfg.lrf) + cfg.lrf


class YoloTrainer:
    def __init__(self, model: YoloModel,
                 cfg: YoloTrainConfig = YoloTrainConfig(),
                 loss_cfg: YoloLossConfig = YoloLossConfig(),
                 steps_per_epoch: int = 100, mesh=None, accumulate: int = 1,
                 device: DeviceLike = "cuda"):
        """``model``: a built :class:`YoloModel` (its plan; the training
        route does not need it loaded).  ``accumulate``: micro-batches
        summed per optimizer step (pass ``accumulate * b`` images to
        :meth:`step`; the reference takes it as nominal_batch / batch).
        ``mesh``: data parallelism over its process group, on its one
        device (which ``device`` then does not name)."""
        self.model = model
        self.mesh = mesh
        self.group = None if mesh is None else mesh_group(mesh)
        self.cfg = cfg
        self.loss_cfg = loss_cfg
        self.steps_per_epoch = steps_per_epoch
        self.accumulate = max(int(accumulate), 1)
        self.device = (resolve_device(device) if mesh is None
                       else mesh.devices[0])
        self.anchors = torch.from_numpy(
            np.asarray(model.anchors, np.float32)).to(self.device)
        self.warmup_steps = max(round(cfg.warmup_epochs * steps_per_epoch),
                                100)

    # ------------------------------------------------------------------
    def init(self, g: Optional[torch.Generator] = None, params=None
             ) -> Dict[str, Any]:
        """The state: ``params`` (leaf tensors; all but the batch norms'
        running statistics require gradients), ``momenta`` (zeros, one for
        each tensor that requires a gradient), ``ema`` (a copy of the
        weights) and ``step``.  Fresh weights come from :func:`yolo_init`
        with ``g`` (default a CPU generator seeded 0), or from ``params``, a
        flat state."""
        if params is None:
            params = yolo_init(self.model, g)
        p = {k: (v.detach() if torch.is_tensor(v)
                 else torch.from_numpy(np.array(v, np.float32))
                 ).to(self.device, torch.float32).clone()
             .requires_grad_(not _is_running_stat(k))
             for k, v in params.items()}
        return {"params": p,
                "momenta": {k: torch.zeros_like(v) for k, v in p.items()
                            if v.requires_grad},
                "ema": {k: v.detach().clone() for k, v in p.items()},
                "step": 0}

    def loss(self, params: Dict[str, Tensor], images: Tensor,
             labels: Tensor):
        """(total, components, new running statistics) of one batch."""
        raws, stats = train_forward(self.model, params,
                                    images.to(self.cfg.compute_dtype),
                                    self.group)
        raws = [r.float() for r in raws]
        total, comps = yolo_loss(raws, labels, self.anchors, self.loss_cfg,
                                 self.group)
        return total, comps, stats

    def grads(self, params: Dict[str, Tensor], images: Tensor,
              labels: Tensor):
        """(gradient of every leaf that requires one (zeros where the loss
        does not reach it), total, components of the last micro-batch,
        running statistics after the last micro-batch).  With
        ``accumulate > 1`` the batch splits into that many equal
        micro-batches (a batch that does not divide raises), and each runs
        on the running statistics the previous ones left, as torch updates
        them on every forward; in training they do not touch the outputs,
        so the summed gradient is the batch's."""
        keys = [k for k, v in params.items() if v.requires_grad]
        if images.shape[0] % self.accumulate:
            raise ValueError(f"a batch of {images.shape[0]} does not split "
                             f"into {self.accumulate} micro-batches")
        n = images.shape[0] // self.accumulate
        mbs = [(images[i * n:(i + 1) * n], labels[i * n:(i + 1) * n])
               for i in range(self.accumulate)]
        cur = dict(params)
        stats: Dict[str, Tensor] = {}
        g_sum: Optional[List[Tensor]] = None
        total = None
        for im, lab in mbs:
            t, comps, st = self.loss(cur, im, lab)
            got = torch.autograd.grad(t, [cur[k] for k in keys],
                                      allow_unused=True)
            g = [torch.zeros_like(params[k]) if v is None else v
                 for k, v in zip(keys, got)]
            g_sum = g if g_sum is None else torch._foreach_add(g_sum, g)
            total = t.detach() if total is None else total + t.detach()
            stats.update(st)
            cur.update(st)
        return dict(zip(keys, g_sum)), total, comps, stats

    def rates(self, step: int) -> Tuple[float, float, float]:
        """(weight lr, bias lr, momentum) at ``step``: the schedule and
        the warm-up ramps (train.py:309-318)."""
        cfg = self.cfg
        base = cfg.lr0 * lr_schedule(cfg, step / self.steps_per_epoch)
        wprog = min(max(step / self.warmup_steps, 0.0), 1.0)
        lr_w = base * wprog
        lr_b = (base if wprog >= 1.0 else
                cfg.warmup_bias_lr + (base - cfg.warmup_bias_lr) * wprog)
        mom = cfg.warmup_momentum + (cfg.momentum - cfg.warmup_momentum) * wprog
        return lr_w, lr_b, mom

    def step(self, state: Dict[str, Any], images, labels):
        """One optimizer step on a batch (numpy or tensors; images NHWC in
        [0, 1], labels (B, T, 5)); returns (state, total loss (0-d tensor),
        components).  A non-finite loss or gradient leaves every tensor of
        the state as it was; the step counter advances either way."""
        images = as_device(images, self.device)
        labels = as_device(labels, self.device)
        params, momenta, ema = state["params"], state["momenta"], state["ema"]
        step = int(state["step"])
        grads, total, comps, stats = self.grads(params, images, labels)
        if self.group is not None:
            got = collectives.average([*grads.values(), total,
                                       *comps.values()], self.group)
            grads = dict(zip(grads, got))
            total = got[len(grads)]
            comps = dict(zip(comps, got[len(grads) + 1:]))
        ok = bool(all_finite([total, *grads.values()]))
        state = dict(state, step=step + 1)
        if not ok:
            return state, total, {k: v.detach() for k, v in comps.items()}

        lr_w, lr_b, mom = self.rates(step)
        wd = self.cfg.weight_decay
        with torch.no_grad():
            for decay, bias in ((True, False), (False, True),
                                (False, False)):
                keys = [k for k in grads if _is_conv_weight(k) == decay
                        and _is_bias(k) == bias]
                if not keys:
                    continue
                p = [params[k] for k in keys]
                m = [momenta[k] for k in keys]
                g = [grads[k] for k in keys]
                if decay:
                    g = torch._foreach_add(g, p, alpha=wd)
                torch._foreach_mul_(m, mom)        # torch SGD, dampening 0
                torch._foreach_add_(m, g)
                upd = torch._foreach_add(g, m, alpha=mom)      # Nesterov
                torch._foreach_add_(p, upd, alpha=-(lr_b if bias else lr_w))
            # running statistics from the forward (BottleneckCSP's
            # standalone batch norm, on its running statistics, keeps them)
            for k, v in stats.items():
                params[k].copy_(v)
            # EMA with ramped decay (torch_utils.py:299-317)
            d = self.cfg.ema_decay * (1.0 - math.exp(-(step + 1)
                                                     / self.cfg.ema_tau))
            e = list(ema.values())
            torch._foreach_mul_(e, d)
            torch._foreach_add_(e, [params[k] for k in ema], alpha=1.0 - d)
        return state, total, {k: v.detach() for k, v in comps.items()}


def validate_map(model: YoloModel, state, batches: Iterable,
                 conf_thres: float = 0.001, iou_thres: float = 0.6,
                 max_det: int = 300, dtype: torch.dtype = torch.float32,
                 device: Optional[DeviceLike] = None) -> Dict[str, Any]:
    """mAP of the weights ``state`` (a flat state: tensors or numpy) over
    ``batches`` of (images (B, H, W, 3) in [0, 1], labels (B, T, 5)[,
    n_real]): the serving model, decode, per-class NMS with
    ``pre_topk=min(512, N)`` and ``multi_label=True``, into the
    :class:`~lpr_tpu_torch.eval.metrics.DetectionEvaluator`.  Rect batches'
    pad rows (past ``n_real``) are skipped.  ``device``: where to run
    (default: where the state's tensors are, else the card)."""
    from lpr_tpu_torch.eval.metrics import DetectionEvaluator
    from lpr_tpu_torch.ops.nms import nms_batched

    first = next(iter(state.values()))
    if device is None:
        device = first.device if torch.is_tensor(first) else "cuda"
    dev = resolve_device(device)
    st = {k: (v.detach().float().cpu().numpy() if torch.is_tensor(v)
              else np.asarray(v, np.float32)) for k, v in state.items()}
    net = model.load_state(st).to(dev).eval()
    ev = DetectionEvaluator()
    for batch in batches:
        images, labels = batch[0], batch[1]
        n_real = batch[2] if len(batch) > 2 else images.shape[0]
        h, w = images.shape[1:3]
        x = as_device(images, dev).to(dtype)
        with torch.no_grad():
            pred, _ = net(x, decode=True)
            det = nms_batched(pred, conf_thres, iou_thres, max_det=max_det,
                              pre_topk=min(512, pred.shape[1]),
                              multi_label=True, agnostic=False)
        det = {k: v.cpu().numpy() for k, v in det.items()}
        for i in range(n_real):
            n = int(det["count"][i])
            lab = np.asarray(labels[i])
            lab = lab[lab[:, 3] > 0]
            gt_xyxy = np.stack([
                (lab[:, 1] - lab[:, 3] / 2) * w, (lab[:, 2] - lab[:, 4] / 2) * h,
                (lab[:, 1] + lab[:, 3] / 2) * w, (lab[:, 2] + lab[:, 4] / 2) * h,
            ], 1) if len(lab) else np.zeros((0, 4), np.float32)
            ev.add(det["boxes"][i][:n], det["scores"][i][:n],
                   det["classes"][i][:n], gt_xyxy, lab[:, 0].astype(int))
    return ev.compute()


def fit_yolo(trainer: YoloTrainer, train_batches_fn, val_batches_fn,
             epochs: int, ckpt_dir: Optional[str] = None,
             patience: int = 100, logger=print, callbacks=None,
             init_params=None) -> Dict[str, Any]:
    """The training shell (reference train.py:265-420): per epoch the
    steps, the EMA weights' validation mAP, fitness-based ``best.npz`` and
    ``last.npz`` (the EMA, flat keys) in ``ckpt_dir``, early stopping.
    ``init_params`` (a flat state) warm-starts.  The returned state carries
    ``summary`` (best and final fitness, final mAP50 and mAP) for the run
    registry."""
    from lpr_tpu_torch.utils.guards import StepGuard
    from lpr_tpu_torch.weights.checkpoint import save_state

    state = trainer.init(params=init_params)
    stopper = EarlyStopping(patience=patience)
    guard = StepGuard()
    best = fit = 0.0
    metrics = {"map50": 0.0, "map": 0.0}
    if callbacks:
        callbacks.run("on_train_start")
    for epoch in range(epochs):
        losses = []
        for images, labels in train_batches_fn():
            state, total, _ = trainer.step(state, images, labels)
            loss = float(total)
            if guard.check(loss):
                losses.append(loss)
        metrics = validate_map(trainer.model, state["ema"], val_batches_fn(),
                               device=trainer.device)
        fit = fitness(metrics)
        logger(f"epoch {epoch}: loss "
               f"{np.mean(losses) if losses else np.nan:.4f} "
               f"mAP50 {metrics['map50']:.4f} mAP {metrics['map']:.4f} "
               f"fitness {fit:.4f}")
        if callbacks:
            callbacks.run("on_fit_epoch_end", epoch, metrics)
        if ckpt_dir:
            save_state(f"{ckpt_dir}/last.npz", state["ema"])
            if fit >= best:
                best = fit
                save_state(f"{ckpt_dir}/best.npz", state["ema"])
        if stopper(epoch, fit):
            logger(f"early stopping at epoch {epoch} (best {best:.4f})")
            break
    if callbacks:
        callbacks.run("on_train_end")
    state["summary"] = {
        "best_fitness": float(best), "final_fitness": float(fit),
        "final_map50": float(metrics["map50"]),
        "final_map": float(metrics["map"]),
    }
    return state


@dataclasses.dataclass
class EarlyStopping:
    """Stop after ``patience`` epochs without fitness improvement
    (reference torch_utils.py:276-296)."""

    patience: int = 100
    best_fitness: float = 0.0
    best_epoch: int = 0

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_fitness = fitness
            self.best_epoch = epoch
        return (epoch - self.best_epoch) >= self.patience


def fitness(metrics: Dict[str, float]) -> float:
    """0.9*mAP50-95 + 0.1*mAP50 (reference utils/metrics.py fitness)."""
    return 0.9 * metrics.get("map", 0.0) + 0.1 * metrics.get("map50", 0.0)
