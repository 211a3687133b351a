"""YOLO detection dataset (counterpart of ``lpr_tpu/data/yolo_data.py``):
YOLO-txt labels, letterbox, mosaic, HSV, perspective, flips, copy-paste,
mixup and cutout, host-side numpy producing fixed-shape batches, without
OpenCV or PIL.

The JAX module runs its image operations in OpenCV where it imports
(``cv2.resize`` INTER_LINEAR, ``cv2.warpAffine`` with border 114, the HSV
gain through ``cvtColor`` and ``LUT``); this module follows that branch,
with the operations in the host library ``csrc/host_augment.cc``
(:func:`lpr_tpu_torch.native.cv_resize_linear`, ``cv_warp_affine``,
``cv_hsv_lut``; plain numpy versions in :mod:`lpr_tpu_torch.data
.cv_plain`).  Images are read by :func:`lpr_tpu_torch.imageio.read_rgb`;
sizes for the label cache come from the PNG header.  Copy-paste's polygon
masks are filled by :func:`fill_polygon`, the port's rasterizer of PIL's
``ImageDraw.polygon``.  Every draw from the Python ``random.Random``
happens in the JAX module's order, so one seed gives the same samples.

Labels are padded to a fixed ``max_labels`` per image ([class, cx, cy, w,
h] normalized; pad rows have w = 0).
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
from typing import Iterator, List, Optional, Tuple

import numpy as np

from lpr_tpu_torch import imageio, native
from lpr_tpu_torch.data.datasets import list_images


@dataclasses.dataclass(frozen=True)
class YoloAugConfig:
    """Defaults = reference hyp.scratch-low.yaml."""

    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.5
    mosaic: float = 1.0
    use_mosaic9: bool = False
    copy_paste: float = 0.0
    mixup: float = 0.0


def load_yolo_labels(path: str) -> np.ndarray:
    """Read a YOLO .txt label file -> (n, 5) [cls, cx, cy, w, h]."""
    if not os.path.exists(path):
        return np.zeros((0, 5), np.float32)
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 5:
                rows.append([float(x) for x in parts[:5]])
    return (np.asarray(rows, np.float32) if rows
            else np.zeros((0, 5), np.float32))


def letterbox_np(img: np.ndarray, hw: Tuple[int, int], fill: int = 114
                 ) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Host letterbox (reference augmentations.py:91-121, auto=False)."""
    h, w = img.shape[:2]
    oh, ow = hw
    r = min(oh / h, ow / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    out = np.full((oh, ow, 3), fill, np.uint8)
    top, left = (oh - nh) // 2, (ow - nw) // 2
    out[top:top + nh, left:left + nw] = native.cv_resize_linear(img, nw, nh)
    return out, r, (left, top)


def augment_hsv(img: np.ndarray, rng: random.Random, h=0.015, s=0.7,
                v=0.4) -> np.ndarray:
    """Random HSV gains (reference augmentations.py:47-58): the tables in
    float64 numpy as the JAX module builds them, the conversions in C."""
    r = np.array([rng.uniform(-1, 1) * h, rng.uniform(-1, 1) * s,
                  rng.uniform(-1, 1) * v]) + 1
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(np.uint8)
    lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)
    return native.cv_hsv_lut(img, lut_hue, lut_sat, lut_val)


def random_perspective(img: np.ndarray, labels_px: np.ndarray,
                       rng: random.Random, cfg: YoloAugConfig,
                       border: Tuple[int, int] = (0, 0)
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Random affine warp of image + xyxy px labels (reference
    augmentations.py:124-201)."""
    h = img.shape[0] + border[0] * 2
    w = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-cfg.perspective, cfg.perspective)
    P[2, 1] = rng.uniform(-cfg.perspective, cfg.perspective)
    R = np.eye(3)
    a = rng.uniform(-cfg.degrees, cfg.degrees)
    s = rng.uniform(1 - cfg.scale, 1 + cfg.scale)
    cos_a, sin_a = math.cos(math.radians(a)) * s, math.sin(math.radians(a)) * s
    R[:2, :2] = [[cos_a, -sin_a], [sin_a, cos_a]]
    S = np.eye(3)
    S[0, 1] = math.tan(math.radians(rng.uniform(-cfg.shear, cfg.shear)))
    S[1, 0] = math.tan(math.radians(rng.uniform(-cfg.shear, cfg.shear)))
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - cfg.translate, 0.5 + cfg.translate) * w
    T[1, 2] = rng.uniform(0.5 - cfg.translate, 0.5 + cfg.translate) * h
    M = T @ S @ R @ P @ C

    warped = native.cv_warp_affine(img, M[:2], (w, h), 114)

    if len(labels_px):
        n = len(labels_px)
        pts = np.ones((n * 4, 3))
        pts[:, :2] = labels_px[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        pts = pts @ M.T
        pts = pts[:, :2].reshape(n, 8)
        x = pts[:, [0, 2, 4, 6]]
        y = pts[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], 1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        # candidate filter (reference box_candidates): size + area ratio
        ow = labels_px[:, 3] - labels_px[:, 1]
        ohh = labels_px[:, 4] - labels_px[:, 2]
        nw_ = new[:, 2] - new[:, 0]
        nh_ = new[:, 3] - new[:, 1]
        ar = np.maximum(nw_ / (nh_ + 1e-16), nh_ / (nw_ + 1e-16))
        keep = ((nw_ > 2) & (nh_ > 2)
                & (nw_ * nh_ / (ow * ohh * s * s + 1e-16) > 0.1) & (ar < 20))
        labels_px = np.concatenate([labels_px[keep, :1], new[keep]], 1)
    return warped, labels_px


def bbox_ioa(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Intersection of ``box`` with each of ``boxes`` over the area of
    ``boxes`` (reference utils/metrics.py:222-242)."""
    if len(boxes) == 0:
        return np.zeros((0,), np.float32)
    ix = (np.minimum(box[2], boxes[:, 2])
          - np.maximum(box[0], boxes[:, 0])).clip(0)
    iy = (np.minimum(box[3], boxes[:, 3])
          - np.maximum(box[1], boxes[:, 1])).clip(0)
    area = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            + 1e-16)
    return ix * iy / area


def _round_up(f: float) -> int:
    return (int(math.floor(f + 0.5)) if f >= 0.0
            else -int(math.floor(abs(f) + 0.5)))


def _round_down(f: float) -> int:
    return (int(math.ceil(f - 0.5)) if f >= 0.0
            else -int(math.ceil(abs(f) - 0.5)))


def fill_polygon(mask: np.ndarray, points) -> np.ndarray:
    """Set the pixels of the polygon ``points`` ((k, 2) x, y) in the bool
    mask (H, W), in place, as PIL's ``ImageDraw.polygon(..., fill=1)``
    fills a mode "1" image: vertices truncated to integers, an edge list
    (runs of horizontal edges merged, horizontal edges drawn as they
    are), a float32 scanline crossing per edge and row (a vertex at an
    edge's lower end counted twice), each span from the rounded-up start
    to the rounded-down end.  PIL's corner rule for crossings that land on
    whole pixels is not reproduced, so a thin sliver's end row may differ
    from PIL's (ROADMAP section 3)."""
    h, w = mask.shape
    f32 = np.float32
    xy = [(int(float(x)), int(float(y))) for x, y in points]
    edges = []

    def add(x0, y0, x1, y1):
        edges.append({"xmin": min(x0, x1), "xmax": max(x0, x1),
                      "ymin": min(y0, y1), "ymax": max(y0, y1),
                      "x0": x0, "y0": y0,
                      "dx": f32(0) if y0 == y1 else f32(f32(x1 - x0)
                                                       / f32(y1 - y0))})

    for i in range(len(xy) - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            px = xy[i - 1][0]
            if x1 > x0 > px:
                edges[-1]["xmax"] = x1
                continue
            if x1 < x0 < px:
                edges[-1]["xmin"] = x1
                continue
        add(x0, y0, x1, y1)
    if xy and xy[-1] != xy[0]:
        add(*xy[-1], *xy[0])

    def hline(x0, y, x1):
        if 0 <= y < h:
            x0, x1 = max(x0, 0), min(x1, w - 1)
            if x0 <= x1:
                mask[y, x0:x1 + 1] = True

    ymin, ymax = h - 1, 0
    table = []
    for e in edges:
        ymin, ymax = min(ymin, e["ymin"]), max(ymax, e["ymax"])
        if e["ymin"] == e["ymax"]:
            hline(e["xmin"], e["ymin"], e["xmax"])
        else:
            table.append(e)
    for y in range(max(ymin, 0), min(ymax, h) + 1):
        xx = []
        for e in table:
            if e["ymin"] <= y <= e["ymax"]:
                xx.append(f32(f32(y - e["y0"]) * e["dx"] + f32(e["x0"])))
                if y == e["ymax"] and y < ymax:
                    xx.append(xx[-1])
        xx.sort()
        for i in range(1, len(xx), 2):
            xs, xe = _round_up(float(xx[i - 1])), _round_down(float(xx[i]))
            if xe >= xs:
                hline(xs, y, xe)
    return mask


def copy_paste(img, labels_px, rng: random.Random, p: float = 0.5,
               segments: Optional[List[np.ndarray]] = None):
    """Instance copy-paste by horizontal mirroring (reference
    augmentations.py:224-241): for round(p*n) random instances, the
    mirrored instance is pasted when its box obscures every existing label
    by < 30% IoA; ``segments`` (per-instance (k, 2) polygons) give the
    pasted mask where present, else the instance's box."""
    n = len(labels_px)
    if not p or not n:
        return img, labels_px
    h, w = img.shape[:2]
    mask = np.zeros((h, w), bool)
    new_rows = []
    existing = labels_px[:, 1:5]
    for j in rng.sample(range(n), k=round(p * n)):
        l = labels_px[j]
        box = np.array([w - l[3], l[2], w - l[1], l[4]], np.float32)
        if (bbox_ioa(box, existing) < 0.30).all():
            new_rows.append([l[0], *box])
            existing = np.concatenate([existing, box[None]], 0)
            if segments is not None and segments[j] is not None:
                fill_polygon(mask, segments[j])
            else:
                y1, y2 = int(round(l[2])), int(round(l[4]))
                x1, x2 = int(round(l[1])), int(round(l[3]))
                mask[max(y1, 0):max(y2, 0), max(x1, 0):max(x2, 0)] = True
    if new_rows:
        flipped = (img * mask[..., None])[:, ::-1]
        sel = flipped > 0  # per-channel replace, as the reference does
        img = img.copy()
        img[sel] = flipped[sel]
        labels_px = np.concatenate(
            [labels_px, np.asarray(new_rows, np.float32)], 0)
    return img, labels_px


def mixup(img1, labels1, img2, labels2, rng: random.Random):
    """Image mixup with a beta(32, 32) blend (reference
    augmentations.py:231-238)."""
    r = np.float32(rng.betavariate(32.0, 32.0))
    img = img1.astype(np.float32) * r + img2.astype(np.float32) * (1 - r)
    return img.astype(img1.dtype), np.concatenate([labels1, labels2], 0)


def cutout(img, labels_px, rng: random.Random, p: float = 0.5):
    """Random occluding patches (reference augmentations.py:204-228)."""
    if rng.random() >= p:
        return img, labels_px
    h, w = img.shape[:2]
    scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8
    img = img.copy()
    for s in scales:
        mh, mw = int(h * s * rng.random()), int(w * s * rng.random())
        x = rng.randint(0, max(w - mw, 1))
        y = rng.randint(0, max(h - mh, 1))
        img[y:y + mh, x:x + mw] = [rng.randint(64, 191) for _ in range(3)]
    return img, labels_px


class YoloDataset:
    """images dir + labels dir (same stem, .txt), mosaic + aug pipeline."""

    def __init__(self, img_dir: str, label_dir: Optional[str] = None,
                 img_hw: Tuple[int, int] = (640, 640), max_labels: int = 64,
                 augment: bool = True, aug: YoloAugConfig = YoloAugConfig(),
                 seed: int = 0, transform=None, cache_images: bool = False,
                 cache_budget_bytes: int = 4 << 30):
        """``transform``: an optional hook called as transform(img_u8,
        labels_px_xyxy, rng) -> (img, labels) right before the HSV/flip
        stage (the reference's Albumentations point).  ``cache_images``:
        keep decoded images (and parsed labels) in RAM, keyed by path, up
        to ``cache_budget_bytes`` of pixels (the reference's ``--cache
        ram``)."""
        self.paths = list_images(img_dir)
        self.label_dir = label_dir or img_dir.replace("images", "labels")
        self.img_hw = img_hw
        self.max_labels = max_labels
        self.augment = augment
        self.aug = aug
        self.rng = random.Random(seed)
        self.transform = transform
        self._cache: Optional[dict] = {} if cache_images else None
        self._cache_budget = cache_budget_bytes
        self._cache_bytes = 0

    def __len__(self):
        return len(self.paths)

    def cache_all(self, workers: int = 8) -> float:
        """Decode every image into the RAM cache on a thread pool; returns
        GB cached (stops at the budget)."""
        from concurrent.futures import ThreadPoolExecutor

        if self._cache is None:
            self._cache = {}
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(self._load_raw, range(len(self))))
        return self._cache_bytes / 1e9

    def _load_raw(self, i) -> Tuple[np.ndarray, np.ndarray]:
        path = self.paths[i]
        if self._cache is not None:
            hit = self._cache.get(path)
            if hit is not None:
                return hit
        img = imageio.read_rgb(path)
        stem = os.path.splitext(os.path.basename(path))[0]
        labels = load_yolo_labels(os.path.join(self.label_dir,
                                               stem + ".txt"))
        if (self._cache is not None
                and self._cache_bytes + img.nbytes <= self._cache_budget):
            self._cache[path] = (img, labels)
            self._cache_bytes += img.nbytes
        return img, labels

    @staticmethod
    def _to_px(labels: np.ndarray, w: int, h: int) -> np.ndarray:
        """normalized xywh -> px xyxy, keeping the class column."""
        if not len(labels):
            return labels.reshape(0, 5)
        c = labels[:, :1]
        cx, cy = labels[:, 1] * w, labels[:, 2] * h
        bw, bh = labels[:, 3] * w, labels[:, 4] * h
        return np.concatenate(
            [c, np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                          cy + bh / 2], 1)], 1).astype(np.float32)

    def _mosaic4(self, i, rng) -> Tuple[np.ndarray, np.ndarray]:
        """4-image mosaic (reference datasets.py:648-703)."""
        sh, sw = self.img_hw
        yc = int(rng.uniform(sh // 2, 2 * sh - sh // 2))
        xc = int(rng.uniform(sw // 2, 2 * sw - sw // 2))
        idxs = [i] + [rng.randrange(len(self)) for _ in range(3)]
        canvas = np.full((sh * 2, sw * 2, 3), 114, np.uint8)
        all_labels = []
        for k, idx in enumerate(idxs):
            img, labels = self._load_raw(idx)
            h0, w0 = img.shape[:2]
            r = min(sh / h0, sw / w0)
            nh, nw = int(h0 * r), int(w0 * r)
            img = native.cv_resize_linear(img, nw, nh)
            if k == 0:
                x1a, y1a, x2a, y2a = max(xc - nw, 0), max(yc - nh, 0), xc, yc
            elif k == 1:
                x1a, y1a = xc, max(yc - nh, 0)
                x2a, y2a = min(xc + nw, sw * 2), yc
            elif k == 2:
                x1a, y1a = max(xc - nw, 0), yc
                x2a, y2a = xc, min(sh * 2, yc + nh)
            else:
                x1a, y1a = xc, yc
                x2a, y2a = min(xc + nw, sw * 2), min(sh * 2, yc + nh)
            x1b, y1b = nw - (x2a - x1a), nh - (y2a - y1a)
            if k in (1, 3):
                x1b = 0
            if k in (2, 3):
                y1b = 0
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a),
                                           x1b:x1b + (x2a - x1a)]
            lab = self._to_px(labels, nw, nh)
            if len(lab):
                lab[:, [1, 3]] += x1a - x1b
                lab[:, [2, 4]] += y1a - y1b
                all_labels.append(lab)
        labels = (np.concatenate(all_labels)
                  if all_labels else np.zeros((0, 5), np.float32))
        labels[:, 1:] = labels[:, 1:].clip(0, [sw * 2, sh * 2, sw * 2,
                                               sh * 2])
        return canvas, labels

    def _mosaic9(self, i, rng) -> Tuple[np.ndarray, np.ndarray]:
        """9-image mosaic (reference datasets.py:704-778): a 3x3 ring on a
        3s x 3s canvas, then a random s x s window."""
        sh, sw = self.img_hw
        idxs = [i] + [rng.randrange(len(self)) for _ in range(8)]
        canvas = np.full((sh * 3, sw * 3, 3), 114, np.uint8)
        all_labels = []
        cells = [(1, 1), (0, 0), (0, 1), (0, 2), (1, 0), (1, 2),
                 (2, 0), (2, 1), (2, 2)]
        for (gy, gx), idx in zip(cells, idxs):
            img, labels = self._load_raw(idx)
            h0, w0 = img.shape[:2]
            r = min(sh / h0, sw / w0)
            nh, nw = int(h0 * r), int(w0 * r)
            img = native.cv_resize_linear(img, nw, nh)
            y0, x0 = gy * sh, gx * sw
            canvas[y0:y0 + nh, x0:x0 + nw] = img
            lab = self._to_px(labels, nw, nh)
            if len(lab):
                lab[:, [1, 3]] += x0
                lab[:, [2, 4]] += y0
                all_labels.append(lab)
        labels = (np.concatenate(all_labels)
                  if all_labels else np.zeros((0, 5), np.float32))
        yc = int(rng.uniform(sh // 2, 2 * sh - sh // 2)) + sh // 2
        xc = int(rng.uniform(sw // 2, 2 * sw - sw // 2)) + sw // 2
        yc = min(max(yc, 0), 2 * sh)
        xc = min(max(xc, 0), 2 * sw)
        win = canvas[yc:yc + sh, xc:xc + sw]
        if len(labels):
            labels[:, [1, 3]] -= xc
            labels[:, [2, 4]] -= yc
            labels[:, 1:] = labels[:, 1:].clip(0, [sw, sh, sw, sh])
            keep = ((labels[:, 3] - labels[:, 1] > 2)
                    & (labels[:, 4] - labels[:, 2] > 2))
            labels = labels[keep]
        return np.ascontiguousarray(win), labels

    def get(self, i, rng: Optional[random.Random] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
        """One sample: (img_hw RGB uint8, (max_labels, 5) padded labels).
        ``rng``: this sample's generator (parallel loading); default the
        dataset's sequential one."""
        rng = self.rng if rng is None else rng
        oh, ow = self.img_hw
        if self.augment and rng.random() < self.aug.mosaic:
            if self.aug.use_mosaic9:
                img, labels_px = self._mosaic9(i, rng)
                img, labels_px = random_perspective(img, labels_px, rng,
                                                    self.aug)
            else:
                img, labels_px = self._mosaic4(i, rng)
                # reference order: copy_paste inside load_mosaic, before
                # the warp (datasets.py:684)
                img, labels_px = copy_paste(img, labels_px, rng,
                                            p=self.aug.copy_paste)
                img, labels_px = random_perspective(
                    img, labels_px, rng, self.aug,
                    border=(-oh // 2, -ow // 2))
                # mixup with a second full mosaic sample after the warp
                # (datasets.py:545-548)
                if rng.random() < self.aug.mixup:
                    j = rng.randrange(len(self.paths))
                    img2, lab2 = self._mosaic4(j, rng)
                    img2, lab2 = copy_paste(img2, lab2, rng,
                                            p=self.aug.copy_paste)
                    img2, lab2 = random_perspective(
                        img2, lab2, rng, self.aug,
                        border=(-oh // 2, -ow // 2))
                    img, labels_px = mixup(img, labels_px, img2, lab2, rng)
        else:
            raw, labels = self._load_raw(i)
            img, r, (dx, dy) = letterbox_np(raw, self.img_hw)
            labels_px = self._to_px(labels, raw.shape[1], raw.shape[0])
            if len(labels_px):
                labels_px[:, 1:] = labels_px[:, 1:] * r
                labels_px[:, [1, 3]] += dx
                labels_px[:, [2, 4]] += dy
            if self.augment:
                img, labels_px = random_perspective(img, labels_px, rng,
                                                    self.aug)
        if self.augment and self.transform is not None:
            img, labels_px = self.transform(img, labels_px, rng)
        if self.augment:
            img = augment_hsv(img, rng, self.aug.hsv_h, self.aug.hsv_s,
                              self.aug.hsv_v)
            if rng.random() < self.aug.flipud:
                img = img[::-1]
                if len(labels_px):
                    y1 = labels_px[:, 2].copy()
                    labels_px[:, 2] = img.shape[0] - labels_px[:, 4]
                    labels_px[:, 4] = img.shape[0] - y1
            if rng.random() < self.aug.fliplr:
                img = img[:, ::-1]
                if len(labels_px):
                    x1 = labels_px[:, 1].copy()
                    labels_px[:, 1] = img.shape[1] - labels_px[:, 3]
                    labels_px[:, 3] = img.shape[1] - x1
        out = np.zeros((self.max_labels, 5), np.float32)
        n = min(len(labels_px), self.max_labels)
        if n:
            l = labels_px[:n]
            out[:n, 0] = l[:, 0]
            out[:n, 1] = (l[:, 1] + l[:, 3]) / 2 / img.shape[1]
            out[:n, 2] = (l[:, 2] + l[:, 4]) / 2 / img.shape[0]
            out[:n, 3] = (l[:, 3] - l[:, 1]) / img.shape[1]
            out[:n, 4] = (l[:, 4] - l[:, 2]) / img.shape[0]
        return np.ascontiguousarray(img), out

    def batches(self, batch_size: int, shuffle: bool = True,
                workers: int = 0, prefetch: int = 2
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Fixed-shape float32 batches.  ``workers > 0`` assembles samples
        on a thread pool (the host library releases the interpreter lock)
        with ``prefetch`` batches in flight; each sample's generator is
        seeded by (epoch, index), so runs stay deterministic whatever the
        worker count."""
        idx = list(range(len(self)))
        if shuffle:
            self.rng.shuffle(idx)
        starts = range(0, len(idx) - batch_size + 1, batch_size)
        if workers <= 0:
            for s in starts:
                items = [self.get(i) for i in idx[s:s + batch_size]]
                imgs, labels = zip(*items)
                yield (np.stack(imgs).astype(np.float32) / 255.0,
                       np.stack(labels))
            return

        from concurrent.futures import ThreadPoolExecutor

        epoch_seed = self.rng.randrange(1 << 30)

        def sample(i):
            return self.get(i, rng=random.Random(epoch_seed * 1000003 + i))

        def assemble(s):
            items = list(pool.map(sample, idx[s:s + batch_size]))
            imgs, labels = zip(*items)
            return (np.stack(imgs).astype(np.float32) / 255.0,
                    np.stack(labels))

        with ThreadPoolExecutor(max_workers=workers) as pool, \
                ThreadPoolExecutor(max_workers=1) as stager:
            pending = []
            for s in starts:
                pending.append(stager.submit(assemble, s))
                while len(pending) > prefetch:
                    yield pending.pop(0).result()
            for f in pending:
                yield f.result()


# ---------------------------------------------------------------------------
# label cache + rectangular (aspect-bucketed) validation batching
# (reference datasets.py:418-424, 466-507): labels and image shapes cached
# in an npz keyed by a files signature; validation batches bucketed into a
# palette of at most three stride-aligned shapes.


def _files_sig(paths: List[str]) -> str:
    """Sizes + mtimes of all files (the reference hashes sizes)."""
    import hashlib

    h = hashlib.md5()
    for p in paths:
        try:
            st = os.stat(p)
            h.update(f"{p}:{st.st_size}:{int(st.st_mtime)};".encode())
        except OSError:
            h.update(f"{p}:missing;".encode())
    return h.hexdigest()


def scan_labels_cached(img_paths: List[str], label_dir: str,
                       cache_path: Optional[str] = None
                       ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Parsed labels + image (h, w) shapes for every image, through a
    persistent ``.lpr_labels.cache.npz`` keyed by the files signature (the
    JAX module's file and layout)."""
    stems = [os.path.splitext(os.path.basename(p))[0] for p in img_paths]
    label_paths = [os.path.join(label_dir, s + ".txt") for s in stems]
    if cache_path is None:
        cache_path = os.path.join(label_dir, ".lpr_labels.cache.npz")
    sig = _files_sig(img_paths + label_paths)
    if os.path.exists(cache_path):
        try:
            with np.load(cache_path, allow_pickle=False) as z:
                if str(z["sig"]) == sig:
                    n = int(z["n"])
                    flat, counts, shapes = z["flat"], z["counts"], z["shapes"]
                    labels, off = [], 0
                    for c in counts:
                        labels.append(flat[off:off + c].reshape(-1, 5))
                        off += c
                    if len(labels) == n:
                        return labels, shapes
        except Exception:
            pass  # stale or corrupt cache: rescan
    labels = [load_yolo_labels(lp) for lp in label_paths]
    shapes = np.zeros((len(img_paths), 2), np.int64)
    for i, p in enumerate(img_paths):
        shapes[i] = imageio.image_hw(p)
    try:
        np.savez_compressed(
            cache_path, sig=sig, n=len(labels),
            flat=(np.concatenate(labels) if labels
                  and sum(len(l) for l in labels)
                  else np.zeros((0, 5), np.float32)),
            counts=np.asarray([len(l) for l in labels], np.int64),
            shapes=shapes)
    except OSError:
        pass  # read-only dataset dir: run uncached
    return labels, shapes


class YoloValDataset:
    """Validation loader: letterbox only, label cache, optional
    rectangular batching through a palette of at most three shapes."""

    def __init__(self, img_dir: str, label_dir: Optional[str] = None,
                 imgsz: int = 640, stride: int = 32, pad: float = 0.5,
                 max_labels: int = 64, square_band: float = 1.15):
        """``pad``: extra stride fractions on the short side (the
        reference's rect pad); ``square_band``: aspect ratios within
        [1/band, band] go to the square bucket."""
        self.paths = list_images(img_dir)
        if not self.paths:
            raise FileNotFoundError(f"no images under {img_dir}")
        self.label_dir = label_dir or img_dir.replace("images", "labels")
        self.imgsz = imgsz
        self.stride = stride
        self.pad = pad
        self.max_labels = max_labels
        self.square_band = square_band
        self.labels, self.shapes = scan_labels_cached(self.paths,
                                                      self.label_dir)

    def __len__(self):
        return len(self.paths)

    def _bucket_shapes(self):
        """Each image's bucket and each bucket's shape, from its extreme
        aspect ratio (stride-aligned, short side capped at imgsz)."""
        ar = self.shapes[:, 0] / self.shapes[:, 1]  # h / w
        band = self.square_band
        bucket = np.where(ar < 1 / band, 0, np.where(ar > band, 2, 1))
        s, st = self.imgsz, self.stride
        shapes = {1: (s, s)}
        if (bucket == 0).any():
            amax = float(ar[bucket == 0].max())
            h = min(int(math.ceil((amax * s + self.pad * st) / st)) * st, s)
            shapes[0] = (h, s)
        if (bucket == 2).any():
            amin = float(ar[bucket == 2].min())
            w = min(int(math.ceil((s / amin + self.pad * st) / st)) * st, s)
            shapes[2] = (s, w)
        return bucket, shapes

    def _sample(self, i: int, hw: Tuple[int, int]):
        img = imageio.read_rgb(self.paths[i])
        out, r, (dx, dy) = letterbox_np(img, hw)
        lab = self.labels[i]
        padded = np.zeros((self.max_labels, 5), np.float32)
        n = min(len(lab), self.max_labels)
        if n:
            l = lab[:n]
            h0, w0 = img.shape[:2]
            oh, ow = hw
            padded[:n, 0] = l[:, 0]
            padded[:n, 1] = (l[:, 1] * w0 * r + dx) / ow
            padded[:n, 2] = (l[:, 2] * h0 * r + dy) / oh
            padded[:n, 3] = l[:, 3] * w0 * r / ow
            padded[:n, 4] = l[:, 4] * h0 * r / oh
        return out, padded

    def batches(self, batch_size: int, rect: bool = True):
        """Deterministic order; with ``rect`` images are grouped by bucket
        so every batch has one shape.  Yields (images, labels, n_real):
        the tail batch is padded to ``batch_size`` with blank rows."""
        if rect:
            bucket, shapes = self._bucket_shapes()
            order = np.argsort(bucket, kind="stable")
            groups = [(shapes[int(bucket[i])], i) for i in order]
        else:
            groups = [((self.imgsz, self.imgsz), i)
                      for i in range(len(self))]
        i = 0
        while i < len(groups):
            hw = groups[i][0]
            idxs = []
            while (i < len(groups) and len(idxs) < batch_size
                   and groups[i][0] == hw):
                idxs.append(groups[i][1])
                i += 1
            real = len(idxs)
            while len(idxs) < batch_size:
                idxs.append(idxs[-1])
            items = [self._sample(j, hw) for j in idxs]
            imgs, labels = zip(*items)
            imgs = np.stack(imgs).astype(np.float32) / 255.0
            labels = np.stack(labels)
            if real < batch_size:
                imgs[real:] = 0.0
                labels[real:] = 0.0
            yield imgs, labels, real
