"""The port's detector data pipeline against the JAX package's, on the CPU:
the host library's three OpenCV operations against cv2 and against their
plain numpy versions, ``YoloDataset.get`` for every augmentation branch
from one ``random.Random`` seed, ``batches`` (with and without worker
threads), the label cache, the rect buckets of ``YoloValDataset``, and
copy-paste with polygon segments.

Bounds (the cv2 installed beside the JAX package is the reference, as the
JAX module runs it):
- ``cv_resize_linear``: equal to ``cv2.resize`` byte for byte;
- ``cv_warp_affine``: within 1 of ``cv2.warpAffine``, on at most 1e-3 of
  the bytes (OpenCV's vector code rounds its float32 taps in another
  order now and then);
- ``cv_hsv_lut``: within 1 of cvtColor -> LUT -> cvtColor, on at most
  2e-3 of the bytes (HSV2RGB's float32 truncation lands the other side of
  a whole number now and then);
- the C library equal to its numpy version byte for byte;
- a sample: labels within 1e-4 px (they are computed identically), the
  image within 9 on at most 1e-3 of the bytes: a warp or resize 1 apart
  feeds the HSV step, where one step of an 8-bit hue (of 180) moves a
  saturated channel by up to 255 * 6 / 180 = 8.5;
- ``fill_polygon`` against PIL's ``ImageDraw.polygon``: on the convex
  test polygons at most 5 of 200 differ, in at most 5e-5 of the pixels
  (PIL's corner rule for crossings on whole pixels is not reproduced;
  ROADMAP section 3)."""

import math
import random

import cv2
import numpy as np
import pytest
from PIL import Image, ImageDraw

from lpr_tpu.data import yolo_data as jd
from lpr_tpu_torch import native
from lpr_tpu_torch.data import cv_plain
from lpr_tpu_torch.data import yolo_data as td
from lpr_tpu_torch.imageio import image_hw, write_png

SIZES = [(37, 53, 20, 31), (50, 60, 100, 120), (720, 1280, 360, 640),
         (720, 1280, 640, 1138), (100, 80, 63, 47), (5, 7, 11, 13),
         (3, 3, 2, 2), (64, 64, 64, 64)]


@pytest.mark.parametrize("h,w,oh,ow", SIZES)
def test_resize_equals_cv2_and_its_plain_version(h, w, oh, ow):
    img = np.random.RandomState(h * w).randint(0, 256, (h, w, 3), np.uint8)
    ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
    got = native.cv_resize_linear(img, ow, oh)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(cv_plain.resize_linear(img, ow, oh), got)


def _affine(rng):
    a = math.radians(rng.uniform(-10, 10))
    s = rng.uniform(0.5, 1.5)
    sh = math.tan(math.radians(rng.uniform(-5, 5)))
    return np.array([[math.cos(a) * s, -math.sin(a) * s + sh,
                      rng.uniform(-30, 30)],
                     [math.sin(a) * s, math.cos(a) * s,
                      rng.uniform(-30, 30)]])


def test_warp_affine_within_one_of_cv2():
    rng = np.random.RandomState(0)
    diff = total = 0
    for _ in range(12):
        img = rng.randint(0, 256, (*rng.randint(20, 240, 2), 3), np.uint8)
        m = _affine(rng)
        dsize = tuple(int(v) for v in rng.randint(20, 240, 2))
        ref = cv2.warpAffine(img, m, dsize=dsize,
                             borderValue=(114, 114, 114))
        got = native.cv_warp_affine(img, m, dsize, 114)
        np.testing.assert_array_equal(cv_plain.warp_affine(img, m, dsize),
                                      got)
        d = np.abs(got.astype(int) - ref)
        assert d.max() <= 1
        diff += int((d > 0).sum())
        total += d.size
    assert diff <= 1e-3 * total, diff / total


def test_hsv_lut_within_one_of_cv2():
    rng = random.Random(0)
    img = np.random.RandomState(1).randint(0, 256, (240, 320, 3), np.uint8)
    diff = total = 0
    for _ in range(6):
        r = np.array([rng.uniform(-1, 1) * 0.015, rng.uniform(-1, 1) * 0.7,
                      rng.uniform(-1, 1) * 0.4]) + 1
        x = np.arange(0, 256, dtype=r.dtype)
        luts = (((x * r[0]) % 180).astype(np.uint8),
                np.clip(x * r[1], 0, 255).astype(np.uint8),
                np.clip(x * r[2], 0, 255).astype(np.uint8))
        hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
        ref = cv2.cvtColor(cv2.merge((cv2.LUT(hue, luts[0]),
                                      cv2.LUT(sat, luts[1]),
                                      cv2.LUT(val, luts[2]))),
                           cv2.COLOR_HSV2RGB)
        got = native.cv_hsv_lut(img, *luts)
        np.testing.assert_array_equal(cv_plain.hsv_lut(img, *luts), got)
        d = np.abs(got.astype(int) - ref)
        assert d.max() <= 1
        diff += int((d > 0).sum())
        total += d.size
    assert diff <= 2e-3 * total, diff / total
    # the forward conversion alone is exact on every colour
    a = np.arange(256)
    every = np.stack(np.meshgrid(a, a, a, indexing="ij"), -1).reshape(
        4096, 4096, 3).astype(np.uint8)
    np.testing.assert_array_equal(cv_plain.rgb2hsv(every),
                                  cv2.cvtColor(every, cv2.COLOR_RGB2HSV))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Eight PNG images of mixed aspect (landscape, square, portrait) with
    1-3 labels each (one image without a label file)."""
    root = tmp_path_factory.mktemp("yolo")
    imd, lbd = root / "images", root / "labels"
    imd.mkdir()
    lbd.mkdir()
    rng = np.random.RandomState(0)
    sizes = [(120, 160), (90, 200), (160, 100), (128, 128), (100, 150),
             (70, 90), (140, 140), (60, 200)]
    for i, (h, w) in enumerate(sizes):
        write_png(str(imd / f"im{i}.png"),
                  (rng.rand(h, w, 3) * 255).astype(np.uint8))
        if i == 5:
            continue
        with open(lbd / f"im{i}.txt", "w") as f:
            for _ in range(rng.randint(1, 4)):
                f.write(f"{rng.randint(0, 3)} {rng.uniform(.2, .8):.4f} "
                        f"{rng.uniform(.2, .8):.4f} {rng.uniform(.1, .4):.4f}"
                        f" {rng.uniform(.1, .4):.4f}\n")
    return str(imd), str(lbd)


AUGS = {
    "defaults": {},
    "letterbox + warp": dict(mosaic=0.0, degrees=10, shear=2),
    "mosaic copy-paste mixup flips": dict(degrees=10, shear=2, flipud=0.5,
                                          copy_paste=0.5, mixup=0.5),
    "mosaic9": dict(use_mosaic9=True, degrees=5),
    "perspective": dict(perspective=0.0005, mosaic=0.5),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_get_matches_jax_from_one_seed(tree, name):
    imd, lbd = tree
    ja = jd.YoloDataset(imd, lbd, (64, 96), max_labels=12, seed=3,
                        aug=jd.YoloAugConfig(**AUGS[name]))
    ta = td.YoloDataset(imd, lbd, (64, 96), max_labels=12, seed=3,
                        aug=td.YoloAugConfig(**AUGS[name]))
    diff = total = 0
    for i in list(range(8)) * 2:
        a, la = ja.get(i)
        b, lb = ta.get(i)
        assert b.shape == a.shape and b.dtype == np.uint8
        np.testing.assert_allclose(lb, la, atol=1e-4, rtol=0)
        d = np.abs(a.astype(int) - b)
        assert d.max() <= 9
        diff += int((d > 0).sum())
        total += d.size
    assert diff <= 1e-3 * total, diff / total
    # the generators drew the same values, in the same order
    assert ja.rng.random() == ta.rng.random()


def test_transform_hook_and_cutout_draw_in_order(tree):
    imd, lbd = tree

    def hook(cut):
        def transform(img, labels, rng):
            return cut(img, labels, rng, p=1.0)
        return transform

    ja = jd.YoloDataset(imd, lbd, (64, 64), seed=1, transform=hook(jd.cutout))
    ta = td.YoloDataset(imd, lbd, (64, 64), seed=1, transform=hook(td.cutout))
    for i in range(4):
        (a, la), (b, lb) = ja.get(i), ta.get(i)
        np.testing.assert_allclose(lb, la, atol=1e-4, rtol=0)
        assert np.abs(a.astype(int) - b).max() <= 9


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_match_jax(tree, workers):
    imd, lbd = tree
    ja = jd.YoloDataset(imd, lbd, (64, 64), seed=7)
    ta = td.YoloDataset(imd, lbd, (64, 64), seed=7, cache_images=True)
    n = 0
    for epoch in range(2):
        for (a, la), (b, lb) in zip(ja.batches(3, workers=workers),
                                    ta.batches(3, workers=workers)):
            assert b.shape == a.shape == (3, 64, 64, 3)
            np.testing.assert_allclose(lb, la, atol=1e-4 / 64, rtol=0)
            assert np.abs(a - b).max() <= 9 / 255 + 1e-6
            n += 1
    assert n == 4 and ta._cache_bytes > 0


def test_val_rect_buckets_and_label_cache_match_jax(tree, tmp_path):
    imd, lbd = tree
    jv = jd.YoloValDataset(imd, lbd, imgsz=96)
    tv = td.YoloValDataset(imd, lbd, imgsz=96)
    jb, js = jv._bucket_shapes()
    tb, ts = tv._bucket_shapes()
    np.testing.assert_array_equal(tb, jb)
    assert ts == js and len(ts) == 3
    for a, b in zip(jv.batches(3), tv.batches(3)):
        assert a[2] == b[2]
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
    # the cache the port writes is the JAX module's file, read back as is
    cache = str(tmp_path / "c.npz")
    paths = tv.paths
    lab, shp = td.scan_labels_cached(paths, lbd, cache)
    jlab, jshp = jd.scan_labels_cached(paths, lbd, cache)
    np.testing.assert_array_equal(jshp, shp)
    for x, y in zip(jlab, lab):
        np.testing.assert_array_equal(x, y)
    assert [tuple(s) for s in shp] == [image_hw(p) for p in paths]
    lab2, _ = td.scan_labels_cached(paths, lbd, cache)
    assert all(np.array_equal(x, y) for x, y in zip(lab, lab2))


def _convex_polygons(n, rng):
    for _ in range(n):
        k = rng.randint(3, 9)
        cx, cy, r = rng.uniform(10, 54), rng.uniform(8, 40), rng.uniform(3, 20)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        yield np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)


def test_fill_polygon_against_pil():
    rng = np.random.RandomState(0)
    bad_polys = bad_px = total = 0
    for pts in _convex_polygons(200, rng):
        m = Image.new("1", (64, 48), 0)
        ImageDraw.Draw(m).polygon([tuple(p) for p in pts], fill=1)
        ref = np.asarray(m, bool)
        got = td.fill_polygon(np.zeros((48, 64), bool), pts)
        d = int((got != ref).sum())
        bad_polys += d > 0
        bad_px += d
        total += ref.size
    assert bad_polys <= 5 and bad_px <= 5e-5 * total, (bad_polys, bad_px)
    # an axis-aligned rectangle and a triangle are exact
    for pts in ([(5, 5), (30, 5), (30, 20), (5, 20)],
                [(10.3, 5.2), (30.7, 12.5), (15.1, 30.9)]):
        m = Image.new("1", (40, 36), 0)
        ImageDraw.Draw(m).polygon(pts, fill=1)
        np.testing.assert_array_equal(
            td.fill_polygon(np.zeros((36, 40), bool), np.asarray(pts)),
            np.asarray(m, bool))


def test_copy_paste_with_segments_matches_jax():
    rng = np.random.RandomState(2)
    img = rng.randint(1, 256, (64, 80, 3), np.uint8)
    labels = np.array([[0, 5, 6, 25, 30], [1, 40, 10, 60, 40],
                       [2, 8, 40, 20, 60]], np.float32)
    segs = [np.array([[5, 6], [25, 8], [20, 30], [6, 28]], np.float32),
            None,
            np.array([[8, 40], [20, 45], [14, 60]], np.float32)]
    for seed in range(4):
        a, la = jd.copy_paste(img, labels, random.Random(seed), p=1.0,
                              segments=segs)
        b, lb = td.copy_paste(img, labels, random.Random(seed), p=1.0,
                              segments=segs)
        np.testing.assert_array_equal(lb, la)
        np.testing.assert_array_equal(b, a)


def test_bbox_ioa_mixup_letterbox_match_jax():
    rng = np.random.RandomState(3)
    box = np.array([10, 10, 50, 40], np.float32)
    boxes = rng.uniform(0, 60, (6, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    np.testing.assert_array_equal(td.bbox_ioa(box, boxes),
                                  jd.bbox_ioa(box, boxes))
    i1 = rng.randint(0, 256, (16, 16, 3), np.uint8)
    i2 = rng.randint(0, 256, (16, 16, 3), np.uint8)
    l1, l2 = np.ones((1, 5), np.float32), np.zeros((2, 5), np.float32)
    a, la = jd.mixup(i1, l1, i2, l2, random.Random(4))
    b, lb = td.mixup(i1, l1, i2, l2, random.Random(4))
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(lb, la)
    raw = rng.randint(0, 256, (90, 200, 3), np.uint8)
    (a, ra, pa), (b, rb, pb) = (jd.letterbox_np(raw, (64, 96)),
                                td.letterbox_np(raw, (64, 96)))
    np.testing.assert_array_equal(b, a)
    assert (ra, pa) == (rb, pb)
