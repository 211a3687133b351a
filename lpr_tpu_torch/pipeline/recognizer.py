"""Batched plate recognition: detect -> enhance -> recognize (counterpart of
``lpr_tpu/pipeline/recognizer.py``).

One step over a batch of frames, all on the device: letterbox, the plate
detector (layers 0-2 through the K1 kernel), lazy-decode NMS, the top
plates by area, per-plate skew estimate and rotated crops (interpolation
matrices), the 2-row -> 1-row reshape, LPSR, the char OCR on the raw crop
and on the SR canvas, and char NMS.  Only the small fixed-shape outputs go
to the host, where :meth:`PlateRecognizer.assemble` builds the strings.

The step keeps the JAX step's cast points: frames are cast to
``cfg.dtype`` and divided by 255, LPSR runs in ``cfg.dtype`` and its output
is cast to float32, the char model gets ``cfg.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lpr_tpu_torch.device import DeviceLike, resolve_device
from lpr_tpu_torch.models.lpsr import LPSR
from lpr_tpu_torch.models.yolo import YoloModel
from lpr_tpu_torch.ops import image as im
from lpr_tpu_torch.ops.boxes import clip_boxes
from lpr_tpu_torch.ops.nms import nms_from_raw
from lpr_tpu_torch.ops.resample import crop_rotated_fast, plate_tile
from lpr_tpu_torch.pipeline.chars import detections_to_string

Tensor = torch.Tensor

PLATE_CLASS_IDS = (7, 8)  # square / rectangle license plate


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    det_hw: Tuple[int, int] = (1280, 1280)
    ocr_hw: Tuple[int, int] = (128, 128)
    sr_hw: Tuple[int, int] = (32, 192)
    det_conf: float = 0.7
    ocr_conf: float = 0.25
    iou: float = 0.3
    max_plates: int = 3
    max_chars: int = 16
    char_pre_topk: int = 64
    long_aspect: float = 1.5
    deskew: bool = True
    dtype: torch.dtype = torch.bfloat16
    # Crops through interpolation-matrix products (ops/resample.py); False
    # takes the gather-based reference sampler (ops/image.py crop_rotated).
    fast_geometry: bool = True
    tile_hw: Tuple[int, int] = (64, 256)
    # OCR on both the raw crop and the SR output (reference parity); False
    # reads the SR output only.
    ocr_on_original: bool = True
    # Run the plate detector's layers 0-2 through the K1 kernel
    # (kernels/yolo_front.py).  On a card it needs bf16; det_hw must be
    # multiples of (32, 64).  The recognizer raises on a configuration the
    # kernel cannot take rather than skipping it.
    fused_front: bool = True


def _aspect_canvas(img: Tensor, canvas_hw: Tuple[int, int]) -> Tensor:
    """Place images (N, sh, sw, C) into canvases (N, ch, cw, C),
    aspect-preserving, centred, black pad (static-shape ResizeImg)."""
    ch, cw = canvas_hw
    sh, sw = int(img.shape[1]), int(img.shape[2])
    scale = min(ch / sh, cw / sw)
    nh, nw = int(round(sh * scale)), int(round(sw * scale))
    resized = im.resize_bilinear(img, (nh, nw))
    canvas = img.new_zeros((img.shape[0], ch, cw, img.shape[-1]))
    t, l = (ch - nh) // 2, (cw - nw) // 2
    canvas[:, t:t + nh, l:l + nw] = resized
    return canvas


def to_host(tree):
    """Copy a step output (dicts of tensors) to numpy."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if tree is None:
        return None
    if tree.dtype == torch.bfloat16:
        tree = tree.float()
    return tree.cpu().numpy()


class PlateRecognizer:
    """Batched detect -> enhance -> recognize.

    Construct with the loaded models; call :meth:`recognize` with a uint8
    frame batch.  The models are moved to ``device`` and cast to
    ``cfg.dtype`` in place."""

    def __init__(self, plate_model: YoloModel, char_model: YoloModel,
                 lpsr_model: LPSR, cfg: PipelineConfig = PipelineConfig(),
                 plate_class_ids: Sequence[int] = PLATE_CLASS_IDS,
                 char_names: Optional[Sequence[str]] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.char_names = char_names
        self.plate_class_ids = tuple(int(i) for i in plate_class_ids)
        # fp32 convolutions and products in full fp32 (cuDNN's TF32 default
        # would change them); bf16 is unaffected.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.plate_model = plate_model.to(self.device, cfg.dtype).eval()
        self.char_model = char_model.to(self.device, cfg.dtype).eval()
        self.lpsr_model = lpsr_model.to(self.device, cfg.dtype).eval()
        self._front = None
        if cfg.fused_front:
            from lpr_tpu_torch.kernels.yolo_front import front_geom, front_pack

            front_geom(*cfg.det_hw)
            if self.device.type == "cuda" and cfg.dtype != torch.bfloat16:
                raise ValueError("fused_front runs the bf16 K1 kernel on a "
                                 "card: use dtype=torch.bfloat16 or "
                                 "fused_front=False")
            self._front = front_pack(self.plate_model)

    # ------------------------------------------------------------------
    def _per_plate(self, x: Tensor, boxes: Tensor):
        """Device-side geometry for every plate (B, P) of frames x."""
        cfg = self.cfg
        B, P = boxes.shape[:2]
        # width clamped like the height: the JAX step divides by the raw
        # width, which gives NaN crops in empty (zero-box) plate slots
        w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1.0)
        h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1.0)
        sh, sw = cfg.sr_hw
        if cfg.fast_geometry:
            tile, geom = plate_tile(x, boxes, cfg.tile_hw)

            def crop(angle, out_hw, **kw):
                return crop_rotated_fast(x, boxes, angle, out_hw, tile=tile,
                                         tile_geom=geom, **kw)
        else:
            def crop(angle, out_hw, **kw):
                return im.crop_rotated(x, boxes, angle, out_hw, **kw)

        zero = torch.zeros((B, P), dtype=torch.float32, device=x.device)
        gray = im.rgb_to_gray(crop(zero, (32, 96)).float())
        aspect = (w / 96.0) / (h / 32.0)
        angle = im.estimate_skew_angle(gray, max_abs_deg=15.0,
                                       pixel_aspect=aspect)
        if not cfg.deskew:
            angle = angle * 0.0
        is_long = (w / h) > cfg.long_aspect
        full = crop(angle, (sh, sw))
        top = crop(angle, (sh, sw // 2), v_range=(-0.5, 0.0))
        bot = crop(angle, (sh, sw // 2), v_range=(0.0, 0.5))
        two_row = torch.cat([top, bot], dim=-2)
        long_img = torch.where(is_long[..., None, None, None], full, two_row)
        ocr_orig = crop(angle, cfg.ocr_hw, square=True, mask_outside=True)
        return long_img, ocr_orig, is_long

    def _sr_to_ocr_canvas(self, sr: Tensor, is_long: Tensor) -> Tensor:
        """SR outputs (N, sh, sw, 1) -> (N, ocr_h, ocr_w, 3) canvases."""
        sw = self.cfg.sr_hw[1]
        rgb = sr.expand(-1, -1, -1, 3)
        restacked = torch.cat([rgb[:, :, :sw // 2], rgb[:, :, sw // 2:]], 1)
        canv_sq = _aspect_canvas(restacked, self.cfg.ocr_hw)
        canv_long = _aspect_canvas(rgb, self.cfg.ocr_hw)
        return torch.where(is_long[:, None, None, None], canv_long, canv_sq)

    @torch.inference_mode()
    def step_raw(self, frames) -> Dict[str, Any]:
        """The device step: uint8 frames (B, H, W, 3) (numpy or tensor) ->
        dict of fixed-shape device tensors (``lpr_tpu``'s ``_step_impl``)."""
        cfg = self.cfg
        if isinstance(frames, np.ndarray):   # torch needs a writable array
            frames = torch.from_numpy(np.require(frames, requirements="W"))
        frames = frames.to(self.device)
        B, fh, fw = int(frames.shape[0]), int(frames.shape[1]), int(frames.shape[2])
        P = cfg.max_plates
        x = frames.to(cfg.dtype) / 255.0
        lb, gain, pad = im.letterbox(x, cfg.det_hw, fill=0.0)
        raws = self.plate_model(lb.contiguous(), front=self._front)
        det = nms_from_raw(raws, self.plate_model.strides,
                           self.plate_model.anchors, cfg.det_conf, cfg.iou,
                           max_det=16, pre_topk=64, multi_label=True,
                           agnostic=True, class_ids=self.plate_class_ids)
        boxes = clip_boxes((det["boxes"] - torch.cat([pad, pad])) / gain,
                           fh, fw)
        areas = ((boxes[..., 2] - boxes[..., 0])
                 * (boxes[..., 3] - boxes[..., 1]))
        areas = torch.where(det["valid"], areas, -1.0)
        # lax.top_k order: descending, ties to the lower index
        top_areas, top_idx = torch.sort(areas, dim=1, descending=True,
                                        stable=True)
        top_areas, top_idx = top_areas[:, :P], top_idx[:, :P]
        sel_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        sel_scores = torch.gather(det["scores"], 1, top_idx)
        sel_classes = torch.gather(det["classes"], 1, top_idx)

        long_img, ocr_orig, is_long = self._per_plate(x, sel_boxes)
        sh, sw = cfg.sr_hw
        oh, ow = cfg.ocr_hw
        sr_out = self.lpsr_model(long_img.reshape(B * P, sh, sw, 3)).float()
        ocr_sr = self._sr_to_ocr_canvas(sr_out, is_long.reshape(B * P))
        if cfg.ocr_on_original:
            ocr_in = torch.cat([ocr_orig.reshape(B * P, oh, ow, 3).float(),
                                ocr_sr], 0)
        else:
            ocr_in = ocr_sr
        cout = self.char_model(ocr_in.to(cfg.dtype).contiguous())
        cdet = nms_from_raw(cout, self.char_model.strides,
                            self.char_model.anchors, cfg.ocr_conf, cfg.iou,
                            max_det=cfg.max_chars, pre_topk=cfg.char_pre_topk,
                            multi_label=True, agnostic=True)
        n_orig = B * P if cfg.ocr_on_original else 0

        def split(lo, hi):
            return {k: v[lo:hi].reshape(B, P, *v.shape[1:])
                    for k, v in cdet.items()}

        return {
            "plate_boxes": sel_boxes,
            "plate_scores": sel_scores,
            "plate_classes": sel_classes,
            "plate_valid": top_areas > 0,
            "is_long": is_long,
            "sr": sr_out.reshape(B, P, sh, sw, 1),
            "chars_orig": split(0, n_orig) if cfg.ocr_on_original else None,
            "chars_sr": split(n_orig, n_orig + B * P),
        }

    def recognize(self, frames) -> List[List[Dict[str, Any]]]:
        """frames: (B, H, W, 3) uint8 RGB.  Per-frame lists of plate dicts
        with the original-crop and SR strings."""
        return self.assemble(to_host(self.step_raw(frames)))

    def assemble(self, out: Dict[str, Any]) -> List[List[Dict[str, Any]]]:
        """Host post-processing of a fetched (:func:`to_host`) step output."""
        results: List[List[Dict[str, Any]]] = []
        kw = {} if self.char_names is None else {"names": self.char_names}
        co, cs = out["chars_orig"], out["chars_sr"]
        B, P = out["plate_valid"].shape
        for b in range(B):
            plates = []
            for p in range(P):
                if not out["plate_valid"][b, p]:
                    continue
                plates.append({
                    "box": out["plate_boxes"][b, p].tolist(),
                    "score": float(out["plate_scores"][b, p]),
                    "class_id": int(out["plate_classes"][b, p]),
                    "is_long": bool(out["is_long"][b, p]),
                    "text": detections_to_string(
                        co["boxes"][b, p], co["classes"][b, p],
                        co["valid"][b, p], **kw) if co is not None else "",
                    "text_sr": detections_to_string(
                        cs["boxes"][b, p], cs["classes"][b, p],
                        cs["valid"][b, p], **kw),
                    "sr": out["sr"][b, p] if "sr" in out else None,
                })
            results.append(plates)
        return results
