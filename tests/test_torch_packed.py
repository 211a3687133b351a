"""The packed detector input: the host letterbox against the JAX package's
host pack, K1's uint8 mode (its plain version against the JAX reference on
the CPU, the kernel against its plain version on a card), and the slice
with ``packed_input`` against the JAX recognizer."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.ops import nn as jnn
from lpr_tpu.ops.pallas import yolo_front as jfront
from lpr_tpu_torch.kernels import yolo_front as kf
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.ops.image import letterbox_host
from lpr_tpu_torch.pipeline import recognizer as trec

from .test_torch_front import CARD_SHAPES
from .test_torch_recognizer import build_pair, compare, synth_frames
from .torch_ref import CHAR, LPSR, PLATE

U8 = 1.0 / 255.0
# K1's uint8 mode against the JAX reference on lb/255 in bf16: the JAX
# kernel test's bounds for its uint8 mode (tests/test_pallas_front.py:
# u8 * bf16(w/255) and bf16(u8/255) * w round apart at the input step).
U8_BF16_MAX = 0.06
U8_BF16_INTERIOR_MEAN = 0.006


def test_letterbox_host_matches_jax_host_pack():
    """letterbox_host, laid out by the JAX package's pack_front_frames,
    equals its pack_front_frames_host: byte for byte where the letterbox
    only pads (720p into 736x1280), within 1 LSB where it resizes (the
    bound of tests/test_native.py for the native taps)."""
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (2, 720, 1280, 3), np.uint8)
    lb = letterbox_host(frames, (736, 1280))
    assert lb.shape == (2, 736, 1280, 3) and lb.dtype == np.uint8
    np.testing.assert_array_equal(
        np.asarray(jfront.pack_front_frames(jnp.asarray(lb))),
        jfront.pack_front_frames_host(frames, (736, 1280)))
    np.testing.assert_array_equal(lb[:, 8:728], frames)
    assert not lb[:, :8].any() and not lb[:, 728:].any()

    small = rng.randint(0, 256, (1, 360, 640, 3), np.uint8)
    got = np.asarray(jfront.pack_front_frames(
        jnp.asarray(letterbox_host(small, (736, 1280))))).astype(int)
    ref = jfront.pack_front_frames_host(small, (736, 1280)).astype(int)
    assert np.abs(got - ref).max() <= 1
    with pytest.raises(ValueError):
        letterbox_host(small.astype(np.float32), (736, 1280))


def _rand_front(rng):
    """Random BN-folded front weights, as tests/test_pallas_front.py draws
    them: the stem in its space-to-depth arrangement (3, 3, 12, 32)."""
    def conv(k, ci, co, scale=0.3):
        return {"w": rng.randn(k, k, ci, co).astype(np.float32) * scale
                / (k * np.sqrt(ci)),
                "b": rng.randn(co).astype(np.float32) * 0.1}

    return conv(3, 12, 32), conv(3, 32, 64), {
        "cv1": conv(1, 64, 32), "cv2": conv(1, 64, 32),
        "cv3": conv(1, 64, 64),
        "m": [{"cv1": conv(1, 32, 32), "cv2": conv(3, 32, 32)}]}


def _set(conv_act, p):
    conv_act.conv.w.copy_(torch.from_numpy(p["w"].transpose(3, 2, 0, 1)))
    conv_act.conv.b.copy_(torch.from_numpy(p["b"]))


@pytest.fixture(scope="module")
def random_front():
    """The plate detector with random layers 0-2, and the JAX reference's
    weights for them."""
    p_stem, p_down, p_c3 = _rand_front(np.random.RandomState(1))
    model = tyolo.load_plate_detector(PLATE, device="cpu")
    l0, l1, l2 = model.layers[:3]
    _set(l0.cv, p_stem)
    _set(l1.cv, p_down)
    for name in ("cv1", "cv2", "cv3"):
        _set(getattr(l2, name), p_c3[name])
    _set(l2.m[0].cv1, p_c3["m"][0]["cv1"])
    _set(l2.m[0].cv2, p_c3["m"][0]["cv2"])
    return model, (p_stem, p_down, p_c3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_front_plain_on_uint8_frames_matches_front_reference(random_front,
                                                             dtype):
    """front_plain on uint8 frames with a pack at input_scale=1/255 (the
    stem folded and rounded to the model's dtype) against the JAX
    front_reference on lb/255 with the unfolded weights: float32 within
    1e-4; bf16 (the model in bf16, the reference on bf16(lb/255)) within
    the JAX uint8 test's 0.06, interior mean 0.006."""
    model, params = random_front
    dt = getattr(torch, dtype)
    pack = kf.front_pack(copy.deepcopy(model).to(dt), input_scale=U8)
    assert pack.dtype == dt and pack.input_scale == U8
    lb = np.random.RandomState(2).randint(0, 256, (1, 64, 128, 3), np.uint8)
    got = kf.front_plain(torch.from_numpy(lb), pack)
    assert got.dtype == dt and got.shape == (1, 16, 32, 64)
    x = jnp.asarray(lb.astype(np.float32) / 255.0)
    if dt == torch.bfloat16:
        x = x.astype(jnp.bfloat16)
    ref = np.asarray(jfront.front_reference(jnn.pixel_unshuffle(x, 2),
                                            *params), np.float32)
    err = np.abs(got.float().numpy() - ref)
    if dt == torch.float32:
        assert err.max() < 1e-4, err.max()
    else:
        assert err.max() < U8_BF16_MAX, err.max()
        assert err[:, 2:-2, 2:-2].mean() < U8_BF16_INTERIOR_MEAN


def test_wrapper_takes_plain_version_on_uint8_cpu_frames(random_front):
    """On the CPU the wrapper runs the plain version on uint8 frames, and
    counts no launch of either instance."""
    model, _ = random_front
    pack = kf.front_pack(model, input_scale=U8)
    x = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (1, 32, 64, 3), np.uint8))
    before = (kf.yolo_front.launches, kf.yolo_front.launches_u8)
    got = kf.yolo_front(x, pack)
    assert (kf.yolo_front.launches, kf.yolo_front.launches_u8) == before
    np.testing.assert_array_equal(got.numpy(),
                                  kf.front_plain(x, pack).numpy())
    # a float pack of the same model on x / 255 gives the same function
    ref = kf.front_plain(x.float() / 255.0, kf.front_pack(model))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4)


def test_front_work_reads_half_the_bytes_as_uint8():
    flops, nbytes = kf.front_work(8, 736, 1280)
    flops8, nbytes8 = kf.front_work(8, 736, 1280, in_bytes=1)
    assert flops8 == flops
    assert nbytes - nbytes8 == 8 * 736 * 1280 * 3


def test_packed_slice_matches_jax_recognizer():
    """The port with packed_input=True (float32, CPU: the host letterbox,
    the uint8 plain front with 1/255 in its stem) against the JAX
    recognizer at packed_input=False (JAX refuses packed input on the
    CPU) on two 180x320 frames at 192x320, a pad-only letterbox: boxes
    within 0.5 px, strings exact (compare's bounds)."""
    jr, _ = build_pair((192, 320))
    tchar, _, ck = tyolo.load_char_ocr_npz(CHAR, device="cpu")
    names = ck.names
    tr = trec.PlateRecognizer(
        tyolo.load_plate_detector(PLATE, device="cpu"), tchar,
        tlpsr.load_lpsr(LPSR, device="cpu"),
        trec.PipelineConfig(det_hw=(192, 320), dtype=torch.float32,
                            packed_input=True),
        char_names=names, device="cpu")
    assert tr._front.input_scale == U8
    results = compare(jr, tr, synth_frames(2, (180, 320), seed=3))
    assert sum(len(f) for f in results) >= 2
    assert any(p["text_sr"] for f in results for p in f)
    with pytest.raises(ValueError):     # packed input needs fused_front
        trec.PlateRecognizer(
            tyolo.load_plate_detector(PLATE, device="cpu"), tchar,
            tlpsr.load_lpsr(LPSR, device="cpu"),
            trec.PipelineConfig(det_hw=(192, 320), dtype=torch.float32,
                                packed_input=True, fused_front=False),
            device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_uint8_kernel_matches_plain_version_on_card(shape):
    """K1's uint8 instance vs front_plain on the same uint8 frames and the
    pack at input_scale=1/255, bf16, real weights, within K1's TOL_*."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    model = tyolo.load_plate_detector(PLATE, device="cuda").to(torch.bfloat16)
    p = kf.front_pack(model, input_scale=U8)
    assert p.bf16_exact
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (*shape, 3), generator=g, device="cuda",
                      dtype=torch.uint8)
    before = (kf.yolo_front.launches, kf.yolo_front.launches_u8)
    got = kf.yolo_front(x, p)
    ref = kf.front_plain(x, p)
    torch.cuda.synchronize()
    assert (kf.yolo_front.launches,
            kf.yolo_front.launches_u8) == (before[0], before[1] + 1)
    assert got.dtype == ref.dtype == torch.bfloat16
    max_err, ratio, interior = kf.front_errors(got, ref)
    assert ratio < 1.0, (max_err, ratio)
    assert interior < kf.TOL_INTERIOR_MEAN, interior
