"""Fixed-shape non-maximum suppression (counterpart of
``lpr_tpu/ops/nms.py``).

Score gate -> top-K candidate selection -> (K, K) IoU -> exact greedy
suppression -> compaction to fixed ``(max_det, ...)`` outputs plus a
validity mask, batched over the leading dimension.  The JAX package picks
candidates with ``approx_max_k(recall_target=0.98)``, which is exact top-k
on the CPU; here it is ``torch.topk``.  Tied scores may be ordered
differently, so the two packages agree on the kept set.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from lpr_tpu_torch.ops.boxes import box_iou, xywh2xyxy

Tensor = torch.Tensor

MAX_WH = 7680.0  # class-offset stride & max box size
MIN_WH = 2.0


def _greedy_suppress(iou: Tensor, valid: Tensor, iou_thres: float) -> Tensor:
    """Exact greedy NMS over score-sorted candidates.

    iou (B, K, K) in score-descending order, valid (B, K) bool.  keep[i]
    holds iff valid[i] and no kept j < i overlaps i above the threshold —
    the keep-set the JAX package's blocked ``fori_loop`` computes."""
    K = iou.shape[-1]
    later = torch.ones(K, K, dtype=torch.bool, device=iou.device).triu(1)
    sup = (iou > iou_thres) & later          # sup[j, i]: j suppresses i
    keep = valid.clone()
    for i in range(1, K):
        hit = (keep[:, :i] & sup[:, :i, i]).any(dim=1)
        keep[:, i] &= ~hit
    return keep


def _suppress_and_compact(boxes: Tensor, top_scores: Tensor, cls_idx: Tensor,
                          valid: Tensor, iou_thres: float, max_det: int,
                          agnostic: bool) -> dict:
    """Shared NMS tail: greedy suppression over score-sorted xyxy candidates
    (B, K, ...) and compaction to (B, max_det, ...) outputs."""
    shifted = boxes if agnostic else (
        boxes + (cls_idx.to(torch.float32) * MAX_WH)[..., None])
    keep = _greedy_suppress(box_iou(shifted, shifted), valid, iou_thres)
    # kept detections to the front, in score order (stable, as jnp.argsort)
    key = torch.where(keep, -top_scores, torch.full_like(top_scores, np.inf))
    order = torch.argsort(key, dim=-1, stable=True)[:, :max_det]
    kept = torch.gather(keep, 1, order)
    sel_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return {
        "boxes": torch.where(kept[..., None], sel_boxes, 0.0),
        "scores": torch.where(kept, torch.gather(top_scores, 1, order), 0.0),
        "classes": torch.where(kept, torch.gather(cls_idx, 1, order),
                               -1).to(torch.int32),
        "valid": kept,
        "count": kept.to(torch.int32).sum(-1),
    }


def _select(scores_mat: Tensor, obj: Tensor, conf_thres: float,
            pre_topk: int, multi_label: bool, cols: Optional[Tensor]):
    """Candidate selection over (B, N, ncc) scores -> (top_scores, box_idx,
    cls_idx), each (B, K)."""
    B, N, ncc = scores_mat.shape
    if multi_label and ncc > 1:
        flat = scores_mat.reshape(B, N * ncc)
        flat = torch.where(flat > conf_thres, flat, -1.0)
        top_scores, top_idx = torch.topk(flat, min(pre_topk, N * ncc), dim=1)
        box_idx = top_idx // ncc
        cls_idx = top_idx % ncc
    else:
        best, cls_of = scores_mat.max(dim=-1)
        gate = (best > conf_thres) & (obj > conf_thres)
        best = torch.where(gate, best, -1.0)
        top_scores, box_idx = torch.topk(best, min(pre_topk, N), dim=1)
        cls_idx = torch.gather(cls_of, 1, box_idx)
    if cols is not None:
        cls_idx = cols[cls_idx]
    return top_scores, box_idx, cls_idx


def nms_batched(pred: Tensor, conf_thres: float = 0.25,
                iou_thres: float = 0.45, max_det: int = 300,
                pre_topk: int = 512, multi_label: bool = True,
                agnostic: bool = True,
                class_ids: Optional[Tuple[int, ...]] = None) -> dict:
    """NMS over decoded predictions pred (B, N, 5+nc) (xywh px, obj, class
    probabilities) -> dict of (B, max_det, ...) arrays."""
    f32 = torch.float32
    obj = pred[..., 4].to(f32)
    wh = pred[..., 2:4]
    size_ok = ((wh >= MIN_WH).all(-1) & (wh <= MAX_WH).all(-1))
    obj = torch.where(size_ok, obj, 0.0)
    cols = None
    cls_probs = pred[..., 5:].to(f32)
    if class_ids is not None:
        cols = torch.tensor(class_ids, dtype=torch.long, device=pred.device)
        cls_probs = cls_probs[..., cols]
    top_scores, box_idx, cls_idx = _select(obj[..., None] * cls_probs, obj,
                                           conf_thres, pre_topk, multi_label,
                                           cols)
    valid = top_scores > conf_thres
    sel = torch.gather(pred[..., :4].to(f32), 1,
                       box_idx[..., None].expand(-1, -1, 4))
    return _suppress_and_compact(xywh2xyxy(sel), top_scores, cls_idx, valid,
                                 iou_thres, max_det, agnostic)


def _decode_constants(raws, strides, anchors, dtype, device):
    """Per-candidate grid xy, anchor wh (px) and stride, in the flatten
    order of the eager decode: scale-major, then (na, ny, nx) row-major."""
    anchors = np.asarray(anchors, np.float32)
    gx_l, gy_l, anc_l, st_l = [], [], [], []
    for l, r in enumerate(raws):
        na, ny, nx = (int(s) for s in r.shape[1:4])
        gy, gx = np.meshgrid(np.arange(ny, dtype=np.float32),
                             np.arange(nx, dtype=np.float32), indexing="ij")
        gx_l.append(np.broadcast_to(gx, (na, ny, nx)).reshape(-1))
        gy_l.append(np.broadcast_to(gy, (na, ny, nx)).reshape(-1))
        anc_l.append(np.repeat(anchors[l] * float(strides[l]), ny * nx,
                               axis=0).reshape(na * ny * nx, 2))
        st_l.append(np.full((na * ny * nx,), float(strides[l]), np.float32))
    grid = np.stack([np.concatenate(gx_l), np.concatenate(gy_l)], -1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return t(grid), t(np.concatenate(anc_l, 0)), t(np.concatenate(st_l))


def nms_from_raw(raws: Sequence[Tensor], strides: Sequence[float], anchors,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, pre_topk: int = 512,
                 multi_label: bool = True, agnostic: bool = True,
                 class_ids: Optional[Tuple[int, ...]] = None) -> dict:
    """Lazy-decode batched NMS straight from raw Detect logits.

    raws: per-scale (B, na, ny, nx, 5+nc) logits.  Candidates are selected
    on the obj x class sigmoids; only the ``pre_topk`` winners get the grid
    and anchor decode (xy = (2s - 0.5 + grid) * stride, wh = (2s)^2 *
    anchor), in the raw dtype as in the JAX package.  The degenerate-box
    gate (MIN_WH/MAX_WH) applies after selection, as there."""
    f32 = torch.float32
    B = raws[0].shape[0]
    ncls = int(raws[0].shape[-1]) - 5
    cdtype, dev = raws[0].dtype, raws[0].device
    grid, anc, stv = _decode_constants(raws, strides, anchors, cdtype, dev)
    cols = None
    if class_ids is not None:
        cols = torch.tensor(class_ids, dtype=torch.long, device=dev)
        cls_cols = [r[..., 5:][..., cols] for r in raws]
    else:
        cls_cols = [r[..., 5:] for r in raws]
    ncc = ncls if cols is None else len(class_ids)
    obj = torch.cat([torch.sigmoid(r[..., 4]).reshape(B, -1) for r in raws],
                    1).to(f32)
    cls = torch.cat([torch.sigmoid(c).reshape(B, -1, ncc) for c in cls_cols],
                    1).to(f32)
    txywh = torch.cat([r[..., :4].reshape(B, -1, 4) for r in raws], 1)

    top_scores, box_idx, cls_idx = _select(obj[..., None] * cls, obj,
                                           conf_thres, pre_topk, multi_label,
                                           cols)
    sig = torch.sigmoid(torch.gather(txywh, 1,
                                     box_idx[..., None].expand(-1, -1, 4)))
    xy = (sig[..., 0:2] * 2.0 - 0.5 + grid[box_idx]) * stv[box_idx][..., None]
    wh = (sig[..., 2:4] * 2.0) ** 2 * anc[box_idx]
    size_ok = (wh >= MIN_WH).all(-1) & (wh <= MAX_WH).all(-1)
    top_scores = torch.where(size_ok, top_scores, -1.0)
    valid = top_scores > conf_thres
    boxes = xywh2xyxy(torch.cat([xy, wh], -1).to(f32))
    return _suppress_and_compact(boxes, top_scores, cls_idx, valid,
                                 iou_thres, max_det, agnostic)
