"""K3, the detector's layers 3-4 as one kernel: the port's packer and plain
version against the JAX package's kernel (interpret mode) and reference,
the detector hook, the wrapper's dispatch and work count, and (on a card)
the CUDA kernel against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.ops.pallas.yolo_mid import (mid_fused, mid_geom, mid_reference,
                                         pack_mid_input, pack_mid_weights)
from lpr_tpu_torch.kernels import yolo_front as kf
from lpr_tpu_torch.kernels import yolo_mid as km
from lpr_tpu_torch.models import yolo as tyolo

from .test_pallas_mid import _rand_params
from .torch_ref import CHAR, PLATE


@pytest.fixture(scope="module")
def case():
    """The JAX mid test's random folded weights and a (1, 64, 96, 64) bf16
    front output, made with numpy from seed 0."""
    rng = np.random.RandomState(0)
    p_l3, p_c3 = _rand_params(rng)
    x = jnp.asarray(rng.rand(1, 64, 96, 64).astype(np.float32)
                    ).astype(jnp.bfloat16)
    return p_l3, p_c3, x


@pytest.mark.parametrize("oracle", ["mid_reference", "mid_fused"])
def test_mid_plain_matches_jax(case, oracle):
    """mid_plain in bf16 vs lpr_tpu's XLA oracle and its kernel (interpret
    mode) at (64, 96), within the JAX kernel test's bounds (max 0.05,
    interior mean 0.006).  The JAX side stores weights in bf16 where the
    port keeps them in float32; measured: max 9.8e-4 against both."""
    p_l3, p_c3, x = case
    if oracle == "mid_reference":
        ref = mid_reference(x, p_l3, p_c3)
    else:
        ref = mid_fused(pack_mid_input(x), pack_mid_weights(p_l3, p_c3),
                        geom=mid_geom(64, 96), interpret=True)
    ref = np.asarray(ref, np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = km.mid_plain(xt, km.mid_pack_folded(p_l3, p_c3))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 32, 48, 128)
    err = np.abs(got.float().numpy() - ref)
    assert err.max() < km.TOL_ABS, err.max()
    assert err[:, 2:-2, 2:-2].mean() < km.TOL_INTERIOR_MEAN


def test_mid_plain_fp32_matches_mid_reference(case):
    p_l3, p_c3, x = case
    x32 = x.astype(jnp.float32)
    ref = np.asarray(mid_reference(x32, p_l3, p_c3))
    got = km.mid_plain(torch.from_numpy(np.asarray(x32)),
                       km.mid_pack_folded(p_l3, p_c3)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_mid_pack_equals_detector_layers_3_4():
    """mid_pack on the yolov5s plate detector + mid_plain == the model's
    own layers 3-4 (BN folded at load), float32."""
    model = tyolo.load_plate_detector(PLATE, device="cpu")
    y = torch.from_numpy(np.random.RandomState(1).rand(1, 32, 48, 64)
                         .astype(np.float32))
    with torch.inference_mode():
        ref = model.layers[4](model.layers[3](y))
        got = km.mid_plain(y, km.mid_pack(model))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_mid_pack_and_geometry_reject_what_the_kernel_cannot_take():
    char, _ = tyolo.load_char_ocr_npz(CHAR, device="cpu")
    with pytest.raises(ValueError):
        km.mid_pack(char)
    assert km.mid_geom(184, 320) == (92, 160)
    for hw in ((183, 320), (184, 321), (0, 64)):
        with pytest.raises(ValueError):
            km.mid_geom(*hw)


def test_detector_hook_equals_unfused_layers():
    """YoloModel.forward(front=, mid=) == running all layers; mid without
    front raises."""
    model = tyolo.load_plate_detector(PLATE, device="cpu")
    x = torch.from_numpy(np.random.RandomState(2).rand(1, 64, 128, 3)
                         .astype(np.float32))
    front, mid = kf.front_pack(model), km.mid_pack(model)
    with torch.inference_mode():
        a = model(x, front=front, mid=mid)
        b = model(x)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        model(x, mid=mid)


def test_wrapper_takes_plain_version_on_cpu(case):
    p_l3, p_c3, x = case
    packed = km.mid_pack_folded(p_l3, p_c3)
    y = torch.from_numpy(np.asarray(x, np.float32))
    before = km.yolo_mid.launches
    got = km.yolo_mid(y, packed)
    assert km.yolo_mid.launches == before
    np.testing.assert_array_equal(got.numpy(), km.mid_plain(y, packed).numpy())
    with pytest.raises(ValueError):
        km.yolo_mid(y.to("meta"), packed)


def test_mid_work_counts_every_convolution():
    """At batch 8, 736x1280 (front grid 184x320): the multiply-adds of the
    seven convolutions counted from the model's own layers (2.77 G per
    image), 60.3 MB read and 30.1 MB written besides the fp32 weights."""
    model = tyolo.load_plate_detector(PLATE, device="cpu")
    macs = 0
    for conv in [model.layers[3].cv] + [
            m for m in model.layers[4].modules()
            if isinstance(m, tyolo.ConvAct)]:
        o, i, kh, kw = conv.conv.w.shape
        macs += o * i * kh * kw
    flops, nbytes = km.mid_work(8, 184, 320)
    assert flops == 2 * macs * 92 * 160 * 8
    assert flops == pytest.approx(44.38e9, rel=1e-3)
    io = 8 * (184 * 320 * 64 + 92 * 160 * 128) * 2
    assert io == pytest.approx(90.4e6, rel=1e-3)
    assert 0 < nbytes - io < 1e6


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """K3 vs mid_plain on the card, bf16, real weights, on K1's output for
    (2, 736, 1280, 3) frames, within km.TOL_* (0.05 + 2 bf16 ulps
    elementwise, interior mean 0.006)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = tyolo.load_plate_detector(PLATE, device="cuda").to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((2, 736, 1280, 3), generator=g, device="cuda"
                   ).to(torch.bfloat16)
    y = kf.yolo_front(x, kf.front_pack(model))
    p = km.mid_pack(model)
    before = km.yolo_mid.launches
    got = km.yolo_mid(y, p)
    ref = km.mid_plain(y, p)
    torch.cuda.synchronize()
    assert km.yolo_mid.launches == before + 1
    assert got.shape == (2, 92, 160, 128)
    max_err, ratio, interior = km.mid_errors(got, ref)
    assert ratio < 1.0, (max_err, ratio)
    assert interior < km.TOL_INTERIOR_MEAN, interior
