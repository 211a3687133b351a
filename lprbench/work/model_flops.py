"""The model floating-point operations of one served frame, counted from
the configuration (never from the program): the plate detector at the
detector input, and for each of the ``max_plates`` plate slots LPSR on one
crop and the char OCR on two canvases (the raw crop and the SR output),
each convolution and matrix product as 2 x its multiply-adds from the
checkpoint's weight shapes (the reference run on meta tensors with its
counter); plus the crop geometry as the two-tap bilinear work it needs
(the tile and every crop, two passes of two taps a value) and the
letterbox's resize as the taps of its weights.  Padded frames are the
caller's to leave out."""

from __future__ import annotations

import functools
import json
from typing import Dict

import numpy as np
import torch

from lprbench.ref import nn as rn
from lprbench.ref.geometry import letterbox_geom, resize_weights
from lprbench.ref.lpsr import Lpsr
from lprbench.ref.yolo import char_ocr, plate_detector


def _count(fn) -> int:
    counter = [0]
    fn(rn.Arith(counter=counter))
    return counter[0]


def _affine(th: int, oh: int, ow: int, c: int = 3) -> int:
    """2 FLOPs a tap, two taps, pass 1 over (th, ow), pass 2 over (oh,
    ow)."""
    return 2 * 2 * c * (th * ow + oh * ow)


def per_frame(cfg: dict) -> Dict[str, int]:
    """FLOPs a served frame by part, and their sum under ``"total"``."""
    return dict(_per_frame(json.dumps(cfg, sort_keys=True)))


@functools.lru_cache(maxsize=None)
def _per_frame(key: str):
    cfg = json.loads(key)
    p, ck = cfg["pipeline"], cfg["checkpoints"]
    meta = torch.device("meta")
    dh, dw = p["det_hw"]
    sh, sw = p["sr_hw"]
    oh, ow = p["ocr_hw"]
    th, tw = p["tile_hw"]
    P = p["max_plates"]
    det = _count(lambda ar: plate_detector(ck["plate_detector"], meta,
                                           ar).raw(
        torch.empty((1, 3, dh, dw), device=meta)))
    lpsr = _count(lambda ar: Lpsr(ck["lpsr"], meta, ar)(
        torch.empty((P, 3, sh, sw), device=meta)))
    ocr = _count(lambda ar: char_ocr(ck["char_ocr"], meta, ar).raw(
        torch.empty((2 * P, 3, oh, ow), device=meta)))
    fh, fw = cfg["frame_hw"]
    _, (nh, nw), _ = letterbox_geom(fh, fw, (dh, dw))
    lb = 0
    if (nh, nw) != (fh, fw):
        taps_y = int(np.count_nonzero(resize_weights(fh, nh)))
        taps_x = int(np.count_nonzero(resize_weights(fw, nw)))
        lb = 2 * 3 * (taps_y * fw + taps_x * nh)
    tile = 2 * 2 * 3 * 2 * th * tw          # two passes of two taps
    crops = (_affine(th, 32, 96) + _affine(th, sh, sw)
             + 2 * _affine(th, sh, sw // 2) + _affine(th, oh, ow))
    geometry = lb + P * (tile + crops)
    parts = {"detector": det, "lpsr": lpsr, "char_ocr": ocr,
             "geometry": geometry}
    parts["total"] = sum(parts.values())
    return tuple(parts.items())
