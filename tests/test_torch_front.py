"""K1, the fused detector front end: the port's packer and plain version
against the JAX package, the wrapper's dispatch, and (on a card) the CUDA
kernel against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.ops import nn as jnn
from lpr_tpu.ops.pallas import yolo_front as jfront
from lpr_tpu_torch.kernels import yolo_front as kf
from lpr_tpu_torch.models import yolo as tyolo

from . import torch_ref
from .torch_ref import PLATE


@pytest.fixture(scope="module")
def jax_plate():
    return torch_ref.plate()


@pytest.fixture(scope="module")
def packed():
    return kf.front_pack(tyolo.load_plate_detector(PLATE, device="cpu"))


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(0).rand(1, 64, 128, 3).astype(np.float32)


def _jax_front_params(params):
    """BN-folded front params as lpr_tpu's front_pack_from_params builds
    them, before its TPU layout packing."""
    fold = jfront._fold_conv
    p0 = fold(params[0])
    w6 = p0["w"].reshape(3, 2, 3, 2, 3, 32).transpose(0, 2, 4, 1, 3, 5)
    p_stem = {"w": w6.reshape(3, 3, 12, 32), "b": p0["b"]}
    c3 = params[2]
    p_c3 = {"cv1": fold(c3["cv1"]), "cv2": fold(c3["cv2"]),
            "cv3": fold(c3["cv3"]),
            "m": [{"cv1": fold(c3["m"][0]["cv1"]),
                   "cv2": fold(c3["m"][0]["cv2"])}]}
    return p_stem, fold(params[1]), p_c3


def test_front_plain_matches_front_reference(jax_plate, packed, frames):
    """Plain version with the port's packer vs lpr_tpu's front_reference on
    the same folded real weights, float32: rounding only."""
    _, params = jax_plate
    x = jnp.asarray(frames)
    ref = jfront.front_reference(jnn.pixel_unshuffle(x, 2),
                                 *_jax_front_params(params))
    got = kf.front_plain(torch.from_numpy(frames), packed).numpy()
    assert got.shape == (1, 16, 32, 64)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-4)


def test_front_plain_matches_jax_model_layers(jax_plate, packed, frames):
    """Plain version vs the JAX model's own layers 0-2 (BN unfolded)."""
    model, params = jax_plate
    y = jnp.asarray(frames)
    for layer, p in zip(model.layers[:3], params[:3]):
        y = layer(p, y)
    got = kf.front_plain(torch.from_numpy(frames), packed).numpy()
    np.testing.assert_allclose(got, np.asarray(y), rtol=0, atol=1e-4)


def test_wrapper_takes_plain_version_on_cpu(packed, frames):
    before = kf.yolo_front.launches
    x = torch.from_numpy(frames)
    got = kf.yolo_front(x, packed)
    assert kf.yolo_front.launches == before       # no kernel launch
    np.testing.assert_array_equal(got.numpy(),
                                  kf.front_plain(x, packed).numpy())
    with pytest.raises(ValueError):
        kf.yolo_front(x.to("meta"), packed)


def test_detector_front_hook_equals_unfused_layers(frames):
    """YoloModel.forward with the packed front == running all layers."""
    model = tyolo.load_plate_detector(PLATE, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 64, 128, 3)
                         .astype(np.float32))
    with torch.inference_mode():
        a = model(x, front=kf.front_pack(model))
        b = model(x)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=0, atol=1e-4)


def test_front_pack_and_geometry_reject_what_the_kernel_cannot_take():
    char, _ = tyolo.load_char_ocr_npz("checkpoints/char_ocr_synth.npz",
                                      device="cpu")
    with pytest.raises(ValueError):
        kf.front_pack(char)
    assert kf.front_geom(736, 1280) == (184, 320)
    for hw in ((720, 1280), (736, 1250), (0, 64)):
        with pytest.raises(ValueError):
            kf.front_geom(*hw)


def test_front_work_at_the_production_shape():
    """Per image at 736x1280: ~2.98 G multiply-adds (5.97 GFLOP), and
    5.65 MB of input + 7.54 MB of output besides the ~0.16 MB of fp32
    weights, which a batch reads once."""
    flops, nbytes = kf.front_work(1, 736, 1280)
    assert flops == pytest.approx(5.97e9, rel=2e-3)
    io = 736 * 1280 * 3 * 2 + 184 * 320 * 64 * 2
    assert io == pytest.approx(13.19e6, rel=1e-3)
    assert 0 < nbytes - io < 2e5
    assert kf.front_work(8, 736, 1280)[1] - nbytes == 7 * io


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """K1 vs front_plain on the card, bf16, real weights, (2, 736, 1280, 3),
    within kf.TOL_* (0.03 + 2 bf16 ulps elementwise over the whole tensor,
    borders included; interior mean 0.004): both round at the same points,
    so only the order of the fp32 sums differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = tyolo.load_plate_detector(PLATE, device="cuda").to(torch.bfloat16)
    p = kf.front_pack(model)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((2, 736, 1280, 3), generator=g, device="cuda"
                   ).to(torch.bfloat16)
    before = kf.yolo_front.launches
    got = kf.yolo_front(x, p)
    ref = kf.front_plain(x, p)
    torch.cuda.synchronize()
    assert kf.yolo_front.launches == before + 1
    max_err, ratio, interior = kf.front_errors(got, ref)
    assert ratio < 1.0, (max_err, ratio)
    assert interior < kf.TOL_INTERIOR_MEAN, interior
