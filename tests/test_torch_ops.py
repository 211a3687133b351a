"""The port's ops (lpr_tpu_torch.ops) against the JAX package's, on the CPU.

Inputs come from seeded numpy and go to both sides as numpy arrays.  JAX
runs at 'highest' precision (tests/conftest.py) and the port in float32, so
the point of each comparison is the algorithm; tolerances are float32
rounding of the few reordered sums unless stated otherwise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.ops import image as jim
from lpr_tpu.ops import nms as jnms
from lpr_tpu.ops import nn as jnn
from lpr_tpu.ops import resample as jrs
from lpr_tpu_torch.ops import image as tim
from lpr_tpu_torch.ops import nms as tnms
from lpr_tpu_torch.ops import nn as tnn
from lpr_tpu_torch.ops import resample as trs

T = torch.from_numpy


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("k,stride,padding,groups", [
    (3, 1, "same", 1), (3, 2, 1, 1), (1, 1, 0, 1), (5, 1, "same", 4),
    (6, 2, 2, 1), (7, 1, "same", 1)])
def test_conv2d_matches_jax(k, stride, padding, groups):
    rng = np.random.RandomState(k * 10 + stride)
    x = rng.randn(2, 13, 11, 8).astype(np.float32)
    w = rng.randn(k, k, 8 // groups, 12).astype(np.float32) * 0.2
    b = rng.randn(12).astype(np.float32)
    ref = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     stride=stride, padding=padding, groups=groups)
    got = tnn.conv2d(T(x), T(tnn.hwio_to_oihw(w)), T(b), stride=stride,
                     padding=padding, groups=groups)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_bn_fold_matches_jax_conv_then_batch_norm():
    """conv + inference BN (JAX, unfolded) == conv with BN folded at load
    (port); folding reorders one multiply, so float32 rounding only."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 9, 9, 6).astype(np.float32)
    w = rng.randn(3, 3, 6, 5).astype(np.float32) * 0.3
    g, be, mu = (rng.randn(5).astype(np.float32) for _ in range(3))
    var = rng.rand(5).astype(np.float32) + 0.5
    y = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), padding=1)
    ref = jnn.batch_norm(y, g, be, mu, var, eps=1e-3)
    wf, bf = tnn.fuse_conv_bn(w, None, g, be, mu, var)
    got = tnn.conv2d(T(x), T(tnn.hwio_to_oihw(wf)), T(bf), padding=1)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_silu_flush_matches_jax():
    x = np.array([-200.0, -80.0, -69.0, -5.0, -1e-31, 0.0, 1e-31, 0.5,
                  3.0, 40.0], np.float32)
    np.testing.assert_allclose(_np(tnn.silu(T(x))),
                               np.asarray(jnn.silu(jnp.asarray(x))),
                               rtol=1e-6, atol=0)
    assert _np(tnn.silu(T(x)))[1] == 0.0   # flushed tail


@pytest.mark.parametrize("name", ["pixel_unshuffle", "pixel_shuffle",
                                  "space_to_depth_focus", "upsample_nearest",
                                  "max_pool2d", "depthwise_conv2d"])
def test_layout_ops_exact(name):
    """Pure data movement (and a max) must agree bit for bit."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 12, 8).astype(np.float32)
    if name in ("pixel_unshuffle", "pixel_shuffle"):
        args = (2,)
    elif name == "upsample_nearest":
        args = (2,)
    elif name == "max_pool2d":
        args = (5, 1, 2)
    else:
        args = ()
    if name == "depthwise_conv2d":
        w = rng.randn(5, 5, 1, 8).astype(np.float32)
        ref = jnn.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w))
        got = tnn.depthwise_conv2d(T(x), T(tnn.hwio_to_oihw(w)))
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        return
    ref = getattr(jnn, name)(jnp.asarray(x), *args)
    got = getattr(tnn, name)(T(x), *args)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_s2d_stem_weight_equals_6x6_stride2_conv():
    """The stem rewrite: space-to-depth + 3x3/p1 with rearranged weights is
    the 6x6/s2/p2 conv."""
    rng = np.random.RandomState(3)
    x = rng.rand(1, 16, 24, 3).astype(np.float32)
    w6 = rng.randn(6, 6, 3, 8).astype(np.float32) * 0.1
    ref = jnn.conv2d(jnp.asarray(x), jnp.asarray(w6), stride=2, padding=2)
    got = tnn.conv2d(tnn.pixel_unshuffle(T(x), 2),
                     T(tnn.hwio_to_oihw(tnn.s2d_stem_weight(w6))), padding=1)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("src_hw,out_hw", [((180, 320), (192, 320)),
                                           ((100, 200), (128, 128)),
                                           ((40, 30), (64, 96))])
def test_letterbox_matches_jax(src_hw, out_hw):
    x = np.random.RandomState(4).rand(2, *src_hw, 3).astype(np.float32)
    ref, rgain, rpad = jim.letterbox(jnp.asarray(x), out_hw, fill=0.0)
    got, gain, pad = tim.letterbox(T(x), out_hw, fill=0.0)
    assert gain == pytest.approx(float(rgain))
    np.testing.assert_array_equal(_np(pad), np.asarray(rpad))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("out_hw", [(85, 128), (21, 128), (64, 256)])
def test_resize_matmul_matches_jax(out_hw):
    x = np.random.RandomState(8).rand(2, 64, 96, 3).astype(np.float32)
    ref = jrs.resize_matmul(jnp.asarray(x), out_hw)
    got = trs.resize_matmul(T(x), out_hw)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("src_hw,out_hw", [((64, 96), (85, 128)),
                                           ((32, 192), (21, 128)),
                                           ((32, 192), (32, 100))])
def test_resize_bilinear_matches_jax_antialias(src_hw, out_hw):
    """Up- and downscaling, including jax.image.resize's antialiasing."""
    x = np.random.RandomState(5).rand(3, *src_hw, 3).astype(np.float32)
    ref = jim.resize_bilinear(jnp.asarray(x), out_hw)
    got = tim.resize_bilinear(T(x), out_hw)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


_BOXES = np.array([[40.0, 30.0, 150.0, 70.0],
                   [10.5, 100.2, 60.7, 160.9],
                   [200.0, 5.0, 310.0, 120.0]], np.float32)
_ANGLES = np.array([0.0, 0.21, -0.12], np.float32)


@pytest.fixture(scope="module")
def frame():
    return np.random.RandomState(6).rand(180, 320, 3).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(out_hw=(32, 96)), dict(out_hw=(32, 192)),
    dict(out_hw=(32, 96), v_range=(-0.5, 0.0)),
    dict(out_hw=(128, 128), square=True, mask_outside=True)])
def test_crop_rotated_fast_and_plate_tile_match_jax(frame, kw):
    """Batched port (B=1, P=3) vs the per-plate JAX functions."""
    tile, geom = trs.plate_tile(T(frame)[None], T(_BOXES)[None])
    got = trs.crop_rotated_fast(None, T(_BOXES)[None], T(_ANGLES)[None],
                                tile=tile, tile_geom=geom, **kw)[0]
    for p in range(3):
        jt, jg = jrs.plate_tile(jnp.asarray(frame), jnp.asarray(_BOXES[p]))
        np.testing.assert_allclose(_np(tile[0, p]), np.asarray(jt),
                                   rtol=1e-5, atol=1e-5)
        ref = jrs.crop_rotated_fast(jnp.asarray(frame),
                                    jnp.asarray(_BOXES[p]),
                                    jnp.float32(_ANGLES[p]), tile=jt,
                                    tile_geom=jg, **kw)
        np.testing.assert_allclose(_np(got[p]), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_crop_rotated_gather_matches_jax(frame):
    got = tim.crop_rotated(T(frame)[None], T(_BOXES)[None], T(_ANGLES)[None],
                           (32, 96), mask_outside=True, square=True)[0]
    for p in range(3):
        ref = jim.crop_rotated(jnp.asarray(frame), jnp.asarray(_BOXES[p]),
                               jnp.float32(_ANGLES[p]), (32, 96),
                               mask_outside=True, square=True)
        np.testing.assert_allclose(_np(got[p]), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("deg,aspect", [(0.0, 1.0), (7.0, 1.0),
                                        (-11.0, 2.5), (4.0, 0.7)])
def test_estimate_skew_angle_matches_jax(deg, aspect):
    """A tilted stripe pattern plus noise; float32 rounding of the means
    moves atan2 by well under 1e-5 rad."""
    yy, xx = np.mgrid[0:32, 0:96].astype(np.float32)
    t = math.radians(deg)
    g = np.sin((yy * math.cos(t) - xx * math.sin(t)) * 0.8).astype(np.float32)
    g += np.random.RandomState(7).rand(32, 96).astype(np.float32) * 0.1
    ref = jim.estimate_skew_angle(jnp.asarray(g), 15.0, pixel_aspect=aspect)
    got = tim.estimate_skew_angle(T(g)[None], 15.0,
                                  pixel_aspect=torch.tensor([aspect]))
    np.testing.assert_allclose(_np(got)[0], float(ref), atol=1e-5)


def _raws(seed, shapes, no):
    rng = np.random.RandomState(seed)
    return [(rng.randn(2, 3, ny, nx, no) * 2.0 - 1.0).astype(np.float32)
            for ny, nx in shapes]


def _kept(d, b):
    """Kept detections of image b as a set of rounded (box, class) rows."""
    v = np.asarray(d["valid"][b])
    rows = np.concatenate([np.asarray(d["boxes"][b])[v],
                           np.asarray(d["classes"][b])[v, None]], 1)
    return sorted(map(tuple, np.round(rows, 3)))


@pytest.mark.parametrize("kw", [
    dict(class_ids=(7, 8), max_det=16, pre_topk=64, multi_label=True,
         agnostic=True, conf_thres=0.5, iou_thres=0.3),
    dict(class_ids=None, max_det=16, pre_topk=64, multi_label=True,
         agnostic=True, conf_thres=0.25, iou_thres=0.3),
    dict(class_ids=None, max_det=20, pre_topk=128, multi_label=False,
         agnostic=False, conf_thres=0.3, iou_thres=0.45)])
def test_nms_from_raw_matches_jax(kw):
    """Same kept sets (tie order may differ: approx_max_k vs topk), and the
    kept scores, in score order, to float32 rounding."""
    shapes = [(8, 12), (4, 6)]
    raws = _raws(11, shapes, 16)
    anchors = np.array([[[1.2, 1.6], [2.0, 3.7], [4.1, 2.9]],
                        [[1.9, 3.8], [3.9, 2.8], [3.7, 7.4]]], np.float32)
    strides = (8, 16)
    ref = jax.device_get(jnms.nms_from_raw([jnp.asarray(r) for r in raws],
                                           strides, anchors, **kw))
    got = tnms.nms_from_raw([T(r) for r in raws], strides, anchors, **kw)
    got = {k: _np(v) for k, v in got.items()}
    for b in range(2):
        assert int(got["count"][b]) == int(ref["count"][b])
        assert _kept(got, b) == _kept(ref, b)
        np.testing.assert_allclose(got["scores"][b], ref["scores"][b],
                                   rtol=1e-6, atol=1e-7)


def test_nms_batched_matches_reference_golden(char_yolo_golden):
    """The reference non_max_suppression's output on the char model's real
    predictions (tests/fixtures/nms_golden.npz)."""
    ref_dets = np.load("tests/fixtures/nms_golden.npz")
    out = tnms.nms_batched(T(char_yolo_golden["pred"]), conf_thres=0.25,
                           iou_thres=0.3, max_det=300)
    for i in range(char_yolo_golden["pred"].shape[0]):
        ref = ref_dets[f"det{i}"]
        n = int(out["count"][i])
        assert n == len(ref)
        if n:
            ref = ref[np.argsort(-ref[:, 4])]
            np.testing.assert_allclose(_np(out["boxes"][i][:n]), ref[:, :4],
                                       atol=1e-2)
            np.testing.assert_allclose(_np(out["scores"][i][:n]), ref[:, 4],
                                       atol=1e-4)
            np.testing.assert_array_equal(_np(out["classes"][i][:n]),
                                          ref[:, 5])


def test_nms_batched_matches_synthetic_golden():
    """Dense clustered synthetic candidates (nms_synth_golden.npz)."""
    d = np.load("tests/fixtures/nms_synth_golden.npz")
    out = tnms.nms_batched(T(d["raw"]), conf_thres=0.25, iou_thres=0.45,
                           max_det=300)
    n = int(out["count"][0])
    assert n == len(d["det"])
    np.testing.assert_allclose(np.sort(_np(out["scores"][0][:n])),
                               np.sort(d["det"][:, 4]), atol=1e-5)
    np.testing.assert_array_equal(np.sort(_np(out["classes"][0][:n])),
                                  np.sort(d["det"][:, 5].astype(np.int32)))
