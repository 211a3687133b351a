"""The plain reference of the served step, float32 on any device:
detect (letterbox, plate detector, plate NMS, the largest plates) and read
(crops and deskew, LPSR, the char OCR on the raw crop and on the SR
canvas, char NMS, the strings), with the served configuration's constants.
It loads the checkpoints itself and works everything out again from the
uint8 frames the harness handed the server.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from lprbench.ref import geometry as geo
from lprbench.ref import nn as rn
from lprbench.ref.chars import to_string
from lprbench.ref.lpsr import Lpsr
from lprbench.ref.nms import nms
from lprbench.ref.yolo import char_ocr, decode_candidates, plate_detector

PLATE_CLASS_IDS = (7, 8)
# The deskew angle is ill-conditioned: it follows the structure tensor's
# orientation theta of a 32 x 96 grey crop, which the crop's rounding
# moves by up to 0.065 rad at bf16 (the program's crop against this
# reference's, 16 seeds on the card), and on plates whose vertical edges
# dominate (theta near 0) it jumps from -15 to +15 degrees with theta's
# sign.  So a served reading is judged against the reference's reading at
# the angle, among those of the orientations within THETA_SPAN of the
# reference's (THETA_STEPS of them), that is nearest the served SR image.
THETA_SPAN = 0.2
THETA_STEPS = 21
LPSR_CHUNK = 256


class Reference:
    """``cfg``: the configuration file's ``pipeline`` entry (det_hw,
    det_conf, ocr_conf, iou, max_plates, max_chars, char_pre_topk,
    long_aspect, sr_hw, ocr_hw, tile_hw) and its ``checkpoints``."""

    def __init__(self, cfg: dict, device, fp8: bool = False):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg["pipeline"]
        ck = cfg["checkpoints"]
        self.dev = torch.device(device)
        self.ar = rn.Arith(fp8=fp8)
        self.det = plate_detector(ck["plate_detector"], self.dev, self.ar)
        self.ocr = char_ocr(ck["char_ocr"], self.dev, self.ar)
        self.lpsr = Lpsr(ck["lpsr"], self.dev, self.ar)

    def _float_frames(self, frames: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(
            self.dev).float() / 255.0
        return self._round(x)

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the arithmetic holds it: float8 e4m3 for the
        control, else as it is."""
        return rn.round_e4m3(x) if self.ar.fp8 else x

    def serve(self, frames: np.ndarray, dets=None) -> List[List[Dict]]:
        """The reference's own chain, in the program's place: for each
        frame its plates as the server answers them (box, score,
        class_id, sr, text, text_sr), each stage on its own previous
        stage, at its own deskew angle (the end-to-end comparison; with
        ``fp8``, the control of the correctness check).  ``dets``: this
        reference's :meth:`detect` of ``frames``, where already made."""
        c = self.cfg
        if dets is None:
            dets = self.detect(frames)
        boxes = [[p["box"] for p in d["top"]] for d in dets]
        blank = [[np.zeros(c["sr_hw"], np.float32) for _ in b]
                 for b in boxes]
        first = self.read(frames, boxes, blank, spread=False)
        srs = [[q[0]["sr"] for q in f] for f in first]
        second = self.read(frames, boxes, srs, spread=False)
        out = []
        for d, f, g in zip(dets, first, second):
            out.append([{"box": p["box"], "score": p["score"],
                         "class_id": p["cls"], "sr": q[0]["sr"],
                         "text": q[0]["text"], "text_sr": r[0]["text_sr"]}
                        for p, q, r in zip(d["top"], f, g)])
        return out

    @torch.inference_mode()
    def detect(self, frames: np.ndarray) -> List[List[dict]]:
        """uint8 frames (B, H, W, 3) -> for each frame its plates (box
        xyxy in frame px, score, cls, area): under ``"top"`` the
        ``max_plates`` largest of the plate NMS's detections, largest first,
        as served; under ``"all"`` every detection the NMS kept."""
        c = self.cfg
        x = self._float_frames(frames)
        fh, fw = x.shape[1:3]
        lb, gain, (px, py) = geo.letterbox(x, tuple(c["det_hw"]))
        lb = self._round(lb)
        raws = self.det.raw(lb.permute(0, 3, 1, 2))
        xywh, obj, cls = (self._round(t).double().cpu().numpy()
                          for t in decode_candidates(raws, self.det))
        out = []
        for b in range(x.shape[0]):
            kept = nms(xywh[b], obj[b], cls[b], c["det_conf"], c["iou"],
                       16, 64, PLATE_CLASS_IDS)
            plates = []
            for d in kept:
                box = (d["box"] - np.array([px, py, px, py])) / gain
                box = np.clip(box, 0, [fw, fh, fw, fh])
                area = (box[2] - box[0]) * (box[3] - box[1])
                plates.append({"box": box, "score": d["score"],
                               "cls": d["cls"], "area": area})
            order = sorted(range(len(plates)),
                           key=lambda i: -plates[i]["area"])
            top = [plates[i] for i in order[:c["max_plates"]]
                   if plates[i]["area"] > 0]
            out.append({"top": top, "all": plates})
        return out

    @torch.inference_mode()
    def read(self, frames: np.ndarray, boxes: Sequence[Sequence],
             sr_in: Sequence[Sequence], spread: bool = True
             ) -> List[List[List[Dict]]]:
        """uint8 frames (B, H, W, 3), for each frame up to ``max_plates``
        boxes (xyxy frame px) and for each box an SR image (32, 192) ->
        for each box its candidate readings, one for each deskew angle that
        a structure orientation within ``THETA_SPAN`` of the reference's
        gives (the angle is ill-conditioned: see ``THETA_SPAN``): the
        angle, the SR image (32, 192) float32 and the string read from the
        raw crop (``text``) at that angle; ``text_sr`` is read from the
        given SR image.  Without ``spread``, each box's own angle alone."""
        c = self.cfg
        P = c["max_plates"]
        B = len(frames)
        sh, sw = c["sr_hw"]
        oh, ow = c["ocr_hw"]
        box_t = np.zeros((B, P, 4), np.float32)
        given = np.zeros((B, P, sh, sw, 1), np.float32)
        for b, bs in enumerate(boxes):
            for p, bx in enumerate(bs):
                box_t[b, p] = bx
                given[b, p] = np.asarray(sr_in[b][p], np.float32).reshape(
                    sh, sw, 1)
        x = self._float_frames(frames)
        bt = torch.from_numpy(box_t).to(self.dev)
        w = torch.clamp(bt[..., 2] - bt[..., 0], min=1.0)
        h = torch.clamp(bt[..., 3] - bt[..., 1], min=1.0)
        tile, g = geo.plate_tile(x, bt, tuple(c["tile_hw"]))
        zero = torch.zeros((B, P), device=self.dev)
        theta = geo.structure_theta(
            geo.gray(geo.crop(tile, g, bt, zero, (32, 96))))
        aspect = (w / 96.0) / (h / 32.0)
        steps = torch.linspace(-THETA_SPAN, THETA_SPAN, THETA_STEPS,
                               device=self.dev)
        grid = geo.skew_angle(theta[..., None] + steps, 15.0,
                              aspect[..., None])         # (B, P, K)
        first = geo.skew_angle(theta, 15.0, aspect)
        # every plate's own angle first, then its other distinct angles
        cand = []
        for b, bs in enumerate(boxes):
            for p in range(len(bs)):
                seen = [float(first[b, p])]
                for a in grid[b, p].tolist() if spread else ():
                    if all(abs(a - v) > 1e-4 for v in seen):
                        seen.append(a)
                cand.extend((b, p, a) for a in seen)
        if not cand:
            return [[] for _ in boxes]
        bi = torch.tensor([b for b, _, _ in cand], device=self.dev)
        pi = torch.tensor([p for _, p, _ in cand], device=self.dev)
        ang = torch.tensor([a for _, _, a in cand], device=self.dev)[None]
        t_c = tile[bi, pi][None]
        g_c = tuple(v[bi, pi][None] for v in g)
        b_c = bt[bi, pi][None]
        l_c = ((w / h) > c["long_aspect"])[bi, pi][None]
        full = geo.crop(t_c, g_c, b_c, ang, (sh, sw))
        top = geo.crop(t_c, g_c, b_c, ang, (sh, sw // 2), (-0.5, 0.0))
        bot = geo.crop(t_c, g_c, b_c, ang, (sh, sw // 2), (0.0, 0.5))
        long_img = self._round(torch.where(
            l_c[..., None, None, None], full, torch.cat([top, bot], -2)))
        ocr_orig = self._round(geo.crop(t_c, g_c, b_c, ang, (oh, ow),
                                        mask_outside=True, square=True))
        srs, texts = [], []
        for s in range(0, len(cand), LPSR_CHUNK):
            sr = self.lpsr(long_img[0, s:s + LPSR_CHUNK].permute(0, 3, 1, 2))
            srs.append(sr[:, 0].float().cpu().numpy())
            texts += self._ocr(ocr_orig[0, s:s + LPSR_CHUNK])
        srs = np.concatenate(srs)
        is_long = (w / h) > c["long_aspect"]
        src = torch.from_numpy(given).to(self.dev).reshape(-1, sh, sw, 1)
        rgb = src.expand(-1, -1, -1, 3)
        square = geo.aspect_canvas(
            torch.cat([rgb[:, :, :sw // 2], rgb[:, :, sw // 2:]], 1),
            (oh, ow))
        long_c = geo.aspect_canvas(rgb, (oh, ow))
        text_sr = self._ocr(self._round(torch.where(
            is_long.reshape(-1)[:, None, None, None], long_c, square)))
        out = [[[] for _ in bs] for bs in boxes]
        for k, (b, p, a) in enumerate(cand):
            out[b][p].append({"angle": a, "sr": srs[k], "text": texts[k],
                              "text_sr": text_sr[b * P + p]})
        return out

    def _ocr(self, imgs: torch.Tensor) -> List[str]:
        """The char OCR and char NMS on (N, 128, 128, 3) canvases -> N
        strings."""
        c = self.cfg
        raws = self.ocr.raw(imgs.permute(0, 3, 1, 2))
        xywh, obj, cls = (self._round(t).double().cpu().numpy()
                          for t in decode_candidates(raws, self.ocr))
        out = []
        for n in range(imgs.shape[0]):
            kept = nms(xywh[n], obj[n], cls[n], c["ocr_conf"], c["iou"],
                       c["max_chars"], c["char_pre_topk"])
            out.append(to_string([d["box"] for d in kept],
                                 [d["cls"] for d in kept]))
        return out
