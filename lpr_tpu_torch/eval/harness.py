"""Accuracy harness: full-plate accuracy and character error rate (CER),
with and without LPSR (counterpart of ``lpr_tpu/eval/harness.py``).

The reference protocol (``evaluation/eval.py``): ground truth is the
filename stem uppercased; each image is read twice, by the char OCR on the
raw plate image and on the LPSR-enhanced one, and scored by exact
full-plate match and by CER (Levenshtein distance / len(gt)).

Each image is prepared on the host once (:meth:`OcrEvaluator._prep_host`,
with the port's C copies of Pillow's bilinear and bicubic resamples), then
each batch runs on the device as one pass: LPSR (the K2 kernel on a card,
its plain version on the CPU), the uint8 round trip, the SR image's OCR
canvas, the char OCR on the raw and the SR canvases together, and NMS.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lpr_tpu_torch import imageio, native
from lpr_tpu_torch.device import DeviceLike, resolve_device
from lpr_tpu_torch.kernels.lpsr import lpsr_fused, lpsr_kernel_takes, lpsr_pack
from lpr_tpu_torch.models.lpsr import LPSR, LPSRConfig
from lpr_tpu_torch.models.yolo import YoloModel
from lpr_tpu_torch.ops import image as im
from lpr_tpu_torch.ops.nms import nms_batched
from lpr_tpu_torch.pipeline.chars import (OCR_CLASSES,
                                          detections_to_string_conf)
from lpr_tpu_torch.pipeline.recognizer import to_host


def levenshtein(a: str, b: str) -> int:
    """Edit distance (plain dynamic programming)."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def cer(gt: str, pred: str) -> float:
    """Character error rate (reference eval.py:28-33)."""
    if not gt:
        return 1.0 if pred else 0.0
    return levenshtein(gt, pred) / len(gt)


@dataclasses.dataclass
class EvalReport:
    n: int
    acc_raw: float
    acc_sr: float
    cer_raw: float
    cer_sr: float
    per_image: List[Dict]

    def summary(self) -> str:
        return (
            f"n={self.n}  accuracy raw={self.acc_raw*100:.2f}% "
            f"sr={self.acc_sr*100:.2f}% (+{(self.acc_sr-self.acc_raw)*100:.2f})  "
            f"CER raw={self.cer_raw*100:.2f}% sr={self.cer_sr*100:.2f}% "
            f"({(self.cer_sr-self.cer_raw)*100:+.2f})"
        )


class OcrEvaluator:
    """Batched two-path OCR evaluator.

    The defaults are the reference's: OCR at 128x128, conf 0.5 (the
    published protocol), IoU 0.3, SR input 32x192.  The models are moved
    to ``device`` and cast to ``dtype`` in place.  LPSR runs the K2
    kernel for the configuration it takes (float32 or bf16 instance, as
    ``dtype``; its plain version on the CPU), ``LPSR.forward`` for any
    other."""

    def __init__(self, char_model: YoloModel, lpsr_model: LPSR,
                 lpsr_cfg: Optional[LPSRConfig] = None,
                 ocr_hw: Tuple[int, int] = (128, 128),
                 sr_hw: Tuple[int, int] = (32, 192),
                 ocr_conf: float = 0.5, iou: float = 0.3,
                 max_chars: int = 16,
                 names: Sequence[str] = OCR_CLASSES,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if lpsr_cfg is not None and lpsr_cfg != lpsr_model.cfg:
            raise ValueError(f"lpsr_cfg {lpsr_cfg} is not the model's "
                             f"{lpsr_model.cfg}")
        # fp32 convolutions and products in full fp32 (cuDNN's TF32
        # default would move the char OCR's scores on a card)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.char_model = char_model.to(self.device, dtype).eval()
        self.lpsr_model = lpsr_model.to(self.device, dtype).eval()
        self.lpsr_cfg = lpsr_model.cfg
        self.ocr_hw, self.sr_hw = tuple(ocr_hw), tuple(sr_hw)
        self.ocr_conf, self.iou, self.max_chars = ocr_conf, iou, max_chars
        self.names = names
        self.dtype = dtype
        self._lpsr = (lpsr_pack(self.lpsr_model)
                      if lpsr_kernel_takes(self.lpsr_model.cfg) else None)

    # ------------------------------------------------------------------
    def _prep_host(self, img_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host preprocessing of one RGB uint8 image: the OCR canvas (the
        image fitted by Pillow's bilinear resample, centred on black) and
        the SR input (Pillow's bicubic resample to ``sr_hw``), both float32
        in [0, 1] (reference preprocess_for_sr, eval.py:36-46)."""
        oh, ow = self.ocr_hw
        sh, sw = self.sr_hw
        h, w = img_u8.shape[:2]
        scale = min(oh / h, ow / w)
        nh, nw = max(int(h * scale), 1), max(int(w * scale), 1)
        canvas = np.zeros((oh, ow, 3), np.float32)
        rs = native.resize_pil_bilinear(img_u8, (nh, nw)).astype(
            np.float32) / 255.0
        t, l = (oh - nh) // 2, (ow - nw) // 2
        canvas[t:t + nh, l:l + nw] = rs
        sr_in = native.resize_pil_bicubic(img_u8, (sh, sw)).astype(
            np.float32) / 255.0
        return canvas, sr_in

    def _enhance(self, sr_in: torch.Tensor) -> torch.Tensor:
        x = sr_in.to(self.dtype).contiguous()
        if self._lpsr is not None:
            return lpsr_fused(x, self._lpsr)
        return self.lpsr_model(x).float()

    @torch.inference_mode()
    def _device_batch(self, ocr_canvas: torch.Tensor, sr_in: torch.Tensor):
        oh, ow = self.ocr_hw
        sh, sw = self.sr_hw
        # path 2: SR -> gray -> RGB -> uint8 round trip -> OCR canvas
        sr = self._enhance(sr_in)
        rgb = sr.expand(-1, -1, -1, 3) if sr.shape[-1] == 1 else sr
        rgb = im.uint8_to_float(im.float_to_uint8(rgb))
        scale = min(oh / sh, ow / sw)
        nh, nw = int(round(sh * scale)), int(round(sw * scale))
        resized = im.resize_bilinear(rgb, (nh, nw))
        canvas = rgb.new_zeros((rgb.shape[0], oh, ow, 3))
        t, l = (oh - nh) // 2, (ow - nw) // 2
        canvas[:, t:t + nh, l:l + nw] = resized
        both = torch.cat([ocr_canvas, canvas], 0).to(self.dtype).contiguous()
        pred, _ = self.char_model(both, decode=True)
        det = nms_batched(pred, self.ocr_conf, self.iou,
                          max_det=self.max_chars, pre_topk=256,
                          multi_label=True, agnostic=True)
        return det, sr

    def run_batch(self, canvases: np.ndarray, sr_ins: np.ndarray
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """One device batch: OCR canvases (N, oh, ow, 3) and SR inputs (N,
        sh, sw, 3), float32 -> (the NMS output of the 2N OCR images, raw
        first, as numpy; the SR output (N, sh, sw, 1) float32)."""
        det, sr = self._device_batch(
            torch.from_numpy(np.ascontiguousarray(canvases, np.float32)
                             ).to(self.device),
            torch.from_numpy(np.ascontiguousarray(sr_ins, np.float32)
                             ).to(self.device))
        return to_host(det), to_host(sr)

    def evaluate_arrays(self, images: Sequence[np.ndarray],
                        gts: Sequence[str], batch_size: int = 64
                        ) -> EvalReport:
        """Score RGB uint8 images against their ground-truth strings; the
        last batch is padded with zero images to ``batch_size`` (one
        shape for every batch) and the pad rows are dropped."""
        n = len(images)
        per_image: List[Dict] = []
        acc_r = acc_s = 0
        cer_r = cer_s = 0.0
        for start in range(0, n, batch_size):
            chunk = images[start:start + batch_size]
            canvases, sr_ins = zip(*[self._prep_host(x) for x in chunk])
            bsz = len(chunk)
            pad = batch_size - bsz
            oc = np.stack(list(canvases) + [np.zeros_like(canvases[0])] * pad)
            si = np.stack(list(sr_ins) + [np.zeros_like(sr_ins[0])] * pad)
            det, _ = self.run_batch(oc, si)
            for i in range(bsz):
                gt = gts[start + i]
                t_raw, c_raw = self._string(det, i)
                t_sr, c_sr = self._string(det, batch_size + i)
                acc_r += int(t_raw == gt)
                acc_s += int(t_sr == gt)
                cer_r += cer(gt, t_raw)
                cer_s += cer(gt, t_sr)
                per_image.append({"gt": gt, "raw": t_raw, "sr": t_sr,
                                  "raw_conf": c_raw, "sr_conf": c_sr,
                                  "index": start + i})
        return EvalReport(
            n=n, acc_raw=acc_r / max(n, 1), acc_sr=acc_s / max(n, 1),
            cer_raw=cer_r / max(n, 1), cer_sr=cer_s / max(n, 1),
            per_image=per_image)

    def _string(self, det: Dict[str, np.ndarray], j: int) -> Tuple[str, float]:
        return detections_to_string_conf(det["boxes"][j], det["classes"][j],
                                         det["scores"][j], det["valid"][j],
                                         self.names)

    def evaluate_folder(self, folder: str, batch_size: int = 64
                        ) -> EvalReport:
        """Every PNG/JPEG image in the folder, ground truth from the
        filename stem uppercased (eval.py:23-25,94-99)."""
        files = imageio.list_images(folder)
        images = [imageio.read_rgb(os.path.join(folder, f)) for f in files]
        gts = [os.path.splitext(f)[0].upper() for f in files]
        return self.evaluate_arrays(images, gts, batch_size)
