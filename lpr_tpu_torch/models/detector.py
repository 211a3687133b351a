"""Single-model detector wrapper (counterpart of
``lpr_tpu/models/detector.py``): letterbox, forward with the Detect
decode, ``nms_batched``, boxes rescaled to the frame and rounded, on the
device; only the small fixed-shape results go to the host, where
:class:`DetectionResult` holds each image's detections.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from lpr_tpu_torch.device import DeviceLike, resolve_device
from lpr_tpu_torch.models.yolo import YoloModel
from lpr_tpu_torch.ops import image as im
from lpr_tpu_torch.ops.boxes import clip_boxes
from lpr_tpu_torch.ops.nms import nms_batched


@dataclasses.dataclass
class DetectionResult:
    """One image's detections (AutoShape's Detections)."""

    names: List[str]
    boxes: np.ndarray    # (n, 4) xyxy in original image px
    scores: np.ndarray   # (n,)
    classes: np.ndarray  # (n,) int

    def __len__(self):
        return len(self.boxes)

    def tolist(self) -> List[List[Any]]:
        """[name, str(conf), (x1, y1, x2, y2)] rows, the reference
        Detection.char_detection_yolo format."""
        return [
            [self.names[int(c)], str(float(s)), tuple(float(v) for v in b)]
            for b, s, c in zip(self.boxes, self.scores, self.classes)
        ]

    def pandas(self):
        """Records like AutoShape's .pandas() (dict rows; no pandas)."""
        return [
            {"xmin": float(b[0]), "ymin": float(b[1]), "xmax": float(b[2]),
             "ymax": float(b[3]), "confidence": float(s),
             "class": int(c), "name": self.names[int(c)]}
            for b, s, c in zip(self.boxes, self.scores, self.classes)
        ]


class Detector:
    """size/conf/iou mirror the reference Detection constructor.  The
    model is moved to ``device`` and cast to ``dtype`` in place."""

    def __init__(self, model: YoloModel, names: Sequence[str],
                 size: Tuple[int, int] = (640, 640),
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, dtype=torch.bfloat16,
                 agnostic: bool = True, multi_label: bool = True,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device, dtype).eval()
        self.names = list(names)
        self.size = tuple(size)
        self.dtype = dtype
        self.conf_thres, self.iou_thres = conf_thres, iou_thres
        self.max_det = max_det
        self.agnostic, self.multi_label = agnostic, multi_label

    @torch.inference_mode()
    def _step(self, frames: torch.Tensor) -> dict:
        x = frames.to(torch.float32) / 255.0
        fh, fw = int(x.shape[1]), int(x.shape[2])
        lb, gain, pad = im.letterbox(x, self.size, fill=0.0)
        pred, _ = self.model(lb.to(self.dtype).contiguous(), decode=True)
        det = nms_batched(pred, self.conf_thres, self.iou_thres,
                          max_det=self.max_det,
                          pre_topk=min(512, int(pred.shape[1])),
                          multi_label=self.multi_label,
                          agnostic=self.agnostic)
        boxes = (det["boxes"] - torch.cat([pad, pad])) / gain
        det["boxes"] = torch.round(clip_boxes(boxes, fh, fw))
        return det

    def detect_batch(self, frames: np.ndarray) -> List[DetectionResult]:
        """frames: (B, H, W, 3) uint8 RGB."""
        det = self._step(torch.from_numpy(np.ascontiguousarray(frames))
                         .to(self.device))
        det = {k: v.float().cpu().numpy() if v.dtype == torch.bfloat16
               else v.cpu().numpy() for k, v in det.items()}
        out = []
        for i in range(frames.shape[0]):
            n = int(det["count"][i])
            out.append(DetectionResult(self.names, det["boxes"][i][:n],
                                       det["scores"][i][:n],
                                       det["classes"][i][:n]))
        return out

    def detect(self, frame: np.ndarray) -> DetectionResult:
        """One frame (reference Detection.detect)."""
        return self.detect_batch(frame[None])[0]


def load_char_detector(path: str, size=(128, 128), conf_thres=0.25,
                       iou_thres=0.3, device: DeviceLike = "cuda",
                       **kw) -> Detector:
    """The reference usage ``Detection(weights_path=char.pt,
    size=(128, 128))``: the char OCR from the reference's ``.pt`` or the
    repo's npz checkpoint (:func:`~lpr_tpu_torch.models.yolo
    .load_char_ocr`)."""
    from lpr_tpu_torch.models.yolo import load_char_ocr

    model, _, ck = load_char_ocr(path, device=device)
    return Detector(model, ck.names, size, conf_thres, iou_thres,
                    device=device, **kw)
