"""YOLOv5 training loss (counterpart of ``lpr_tpu/train/yolo_loss.py``,
reference ``yolov5/utils/loss.py:91-222``): CIoU box loss, BCE objectness
with IoU targets and per-level balance, BCE classification with label
smoothing.

Targets are assigned on the JAX module's fixed lattice: every (anchor,
target, offset) candidate of the five-offset neighbourhood (the centre
cell and up to two adjacent cells, offset 0.5) is materialized with a
validity mask, so every shape is static.  Labels are (B, T, 5) [class, cx,
cy, w, h] normalized to [0, 1]; pad rows have w == 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from lpr_tpu_torch.ops.boxes import bbox_ciou

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class YoloLossConfig:
    """Hyperparameters (reference data/hyps/hyp.scratch-low.yaml)."""

    box: float = 0.05
    obj: float = 1.0
    cls: float = 0.5
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    label_smoothing: float = 0.0
    gr: float = 1.0  # iou ratio for obj targets


_BALANCE = {1: [4.0], 2: [4.0, 1.0], 3: [4.0, 1.0, 0.4],
            5: [4.0, 1.0, 0.25, 0.06, 0.02]}

# centre + 4 neighbours (loss.py:184-190)
_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


def _bce_logits(logits: Tensor, targets: Tensor, pos_weight: float = 1.0):
    """BCEWithLogits, elementwise."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def build_targets_level(labels: Tensor, anchors: Tensor,
                        grid_hw: Tuple[int, int], anchor_t: float
                        ) -> Dict[str, Tensor]:
    """The candidate lattice of one level for labels (..., T, 5) (one
    image, or a batch in front) and anchors (na, 2) in grid units: dict of
    (..., na, T, 5) tensors — cell indices ``gi``/``gj`` (clipped to the
    grid), ``cls``, ``mask`` (valid candidates) and ``tbox`` (..., na, T,
    5, 4), the target as (dx, dy, w, h) in grid units from its cell."""
    ny, nx = grid_hw
    na = anchors.shape[0]
    dev, f32 = labels.device, labels.dtype
    lead = labels.shape[:-2]
    T = labels.shape[-2]
    valid = labels[..., 3] > 0                                   # (..., T)
    size = torch.tensor([nx, ny], dtype=f32, device=dev)
    gxy = labels[..., 1:3] * size                                # (..., T, 2)
    gwh = labels[..., 3:5] * size

    # anchor ratio filter (loss.py:179-182)
    r = gwh[..., None, :, :] / anchors[:, None, :]               # (.., na, T, 2)
    ratio = torch.maximum(r, 1.0 / torch.clamp_min(r, 1e-9)).amax(-1)
    a_ok = (ratio < anchor_t) & valid[..., None, :]

    # neighbour-cell gates (loss.py:184-189); float % is floor-mod
    gx, gy = gxy[..., 0], gxy[..., 1]
    j = (torch.remainder(gx, 1.0) < 0.5) & (gx > 1.0)
    k = (torch.remainder(gy, 1.0) < 0.5) & (gy > 1.0)
    l = (torch.remainder(nx - gx, 1.0) < 0.5) & (nx - gx > 1.0)
    m = (torch.remainder(ny - gy, 1.0) < 0.5) & (ny - gy > 1.0)
    off_ok = torch.stack([torch.ones_like(j), j, k, l, m], -1)   # (..., T, 5)

    mask = a_ok[..., :, :, None] & off_ok[..., None, :, :]       # (.., na, T, 5)
    offsets = torch.tensor(_OFFSETS, dtype=f32, device=dev)
    gxy_c = gxy[..., None, :, None, :] - offsets                 # (.., 1, T, 5, 2)
    gij = torch.floor(gxy_c).to(torch.int64)
    gi = gij[..., 0].clamp(0, nx - 1)
    gj = gij[..., 1].clamp(0, ny - 1)
    dxy = gxy[..., None, :, None, :] - torch.stack([gi, gj], -1).to(f32)
    shape = (*lead, na, T, 5)
    twh = gwh[..., None, :, None, :].expand(*shape, 2)
    tbox = torch.cat([dxy.expand(*shape, 2), twh], -1)
    return {"gi": gi.expand(shape), "gj": gj.expand(shape), "tbox": tbox,
            "cls": labels[..., 0][..., None, :, None].expand(shape),
            "mask": mask}


def yolo_loss(raws: Sequence[Tensor], labels: Tensor, anchors: Tensor,
              cfg: YoloLossConfig = YoloLossConfig(), group=None
              ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(total loss * batch size (the reference's scaling, loss.py:166),
    {"box", "obj", "cls"}) for the per-level logits raws (B, na, ny, nx,
    5+nc), labels (B, T, 5) and anchors (nl, na, 2) in grid units, in
    float32 (float64 for float64 logits, a reference's).

    ``group``: this rank's share of the loss of the global batch (every
    rank's equal local batch), whose mean over the ranks is JAX's sharded
    loss (``lpr_tpu/train/yolo_loss.py:144,155,167``): the positive count
    is the global one (all-reduced) over the ranks, and the batch size the
    global one; the ``.mean()`` terms need nothing."""
    from lpr_tpu_torch.parallel.collectives import all_reduce_sum, world_size

    nl = len(raws)
    balance = _BALANCE[nl]
    world = world_size(group)
    B = raws[0].shape[0]
    nc = raws[0].shape[-1] - 5
    cp = 1.0 - 0.5 * cfg.label_smoothing
    cn = 0.5 * cfg.label_smoothing
    dev = raws[0].device
    dt = torch.promote_types(raws[0].dtype, torch.float32)
    labels = labels.to(dev, dt)
    anchors = anchors.to(dev, dt)
    zero = torch.zeros((), dtype=dt, device=dev)
    lbox, lobj, lcls = zero, zero, zero

    for li, p in enumerate(raws):
        _, na, ny, nx, no = p.shape
        anc = anchors[li]
        t = build_targets_level(labels, anc, (ny, nx), cfg.anchor_t)
        gi, gj, tbox, tcls, mask = (t["gi"], t["gj"], t["tbox"], t["cls"],
                                    t["mask"])                # (B, na, T, 5)
        w = mask.to(dt)
        n_pos = w.sum() if group is None else all_reduce_sum(w.sum(), group)
        n_pos = torch.clamp_min(n_pos, 1.0) / world

        # predictions at the candidate cells: ps (B, na, T, 5, no)
        a_idx = torch.arange(na, device=dev)[None, :, None, None]
        b_idx = torch.arange(B, device=dev)[:, None, None, None]
        ps = p[b_idx, a_idx, gj, gi]

        pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * anc[None, :, None,
                                                            None, :]
        iou = bbox_ciou(torch.cat([pxy, pwh], -1), tbox)      # (B, na, T, 5)
        lbox = lbox + ((1.0 - iou) * w).sum() / n_pos

        # objectness target: max of the IoUs scattered into the cell map
        with torch.no_grad():
            iou_d = torch.clamp_min(iou, 0.0) * w
            vals = cfg.gr * iou_d + (1.0 - cfg.gr) * w
            flat = ((b_idx * na + a_idx) * ny + gj) * nx + gi
            tobj = torch.zeros(B * na * ny * nx, dtype=dt,
                               device=dev).scatter_reduce(
                0, flat.reshape(-1), vals.reshape(-1), "amax",
                include_self=True).reshape(B, na, ny, nx)
        obj_bce = _bce_logits(p[..., 4], tobj, cfg.obj_pw)
        lobj = lobj + obj_bce.mean() * balance[li]

        if nc > 1:
            # one-hot as jax.nn.one_hot: a class outside [0, nc) is zeros
            hot = tcls.to(torch.int64)[..., None] == torch.arange(
                nc, device=dev)
            t_onehot = hot.to(dt) * (cp - cn) + cn
            cls_bce = _bce_logits(ps[..., 5:], t_onehot, cfg.cls_pw)
            lcls = lcls + (cls_bce.mean(-1) * w).sum() / n_pos

    lbox = lbox * cfg.box
    lobj = lobj * cfg.obj
    lcls = lcls * cfg.cls
    total = (lbox + lobj + lcls) * (B * world)
    return total, {"box": lbox, "obj": lobj, "cls": lcls}
