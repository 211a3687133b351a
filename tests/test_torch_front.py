"""K1, the fused detector front end: the port's packer and plain version
against the JAX package, the wrapper's dispatch, and (on a card) the CUDA
kernel against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lpr_tpu.ops import nn as jnn
from lpr_tpu.ops.pallas import yolo_front as jfront
from lpr_tpu_torch.kernels import yolo_front as kf
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.ops.nn import silu

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


@pytest.fixture(scope="module")
def packed_bf16():
    """The pack of the detector in bf16, whose weights the kernel's bf16
    fragments hold exactly."""
    model = tyolo.load_plate_detector(PLATE, device="cpu")
    return kf.front_pack(model.to(torch.bfloat16))


def _unpack_frags(flat, ksteps, n):
    """The K x N matrix a run of B fragments holds, read as the kernel's
    lanes read it: lane l's 16 bytes of n-tile pair q at k-step s are b0, b1
    of n-tile 2q, then of 2q + 1; register b0 of n-tile t holds
    B[16s + 2(l % 4) + e][8t + l // 4] for e = 0, 1 and b1 the rows 8
    further (the PTX ISA's mma.m16n8k16 B fragment)."""
    f = flat.float().numpy().reshape(ksteps, n // 16, 32, 4, 2)
    b = np.full((16 * ksteps, n), np.nan, np.float32)
    for s in range(ksteps):
        for q in range(n // 16):
            for lane in range(32):
                for word in range(4):
                    t, reg = 2 * q + word // 2, word % 2
                    k = 16 * s + 2 * (lane % 4) + 8 * reg
                    b[k:k + 2, 8 * t + lane // 4] = f[s, q, lane, word]
    return torch.from_numpy(b)


def _unpacked(packed):
    """Each layer's K x N matrix and bias from packed["mma"] and
    packed["bias"]."""
    mats, off = {}, 0
    for key, ksteps, n in kf.MMA_LAYERS:
        size = 16 * ksteps * n
        mats[key] = _unpack_frags(packed["mma"][off:off + size], ksteps, n)
        off += size
    assert off == packed["mma"].numel() == kf.MMA_ELEMS
    sizes = [packed[k].numel() for k in kf.BIAS_KEYS]
    biases = dict(zip(kf.BIAS_KEYS, torch.split(packed["bias"], sizes)))
    return mats, biases


def test_front_pack_b_fragments_give_back_the_weights(packed_bf16):
    """The bf16 B fragments, unpacked on the CPU, are the float32 weights
    bit for bit in the kernel's K order (tap, chunk, channel); the stem's
    kernel channels 12-15 are zero and 0-11 are its space-to-depth channels
    in STEM_CHANNELS order; the biases follow BIAS_KEYS."""
    mats, biases = _unpacked(packed_bf16)
    for key, ksteps, n in kf.MMA_LAYERS:
        b = mats[key]
        assert not torch.isnan(b).any(), key
        assert b.shape == (16 * ksteps, n)
        w = packed_bf16[key]
        if key == "w0":
            stem = b.reshape(3, 3, 16, 32)
            assert torch.equal(stem[:, :, 12:], torch.zeros(3, 3, 4, 32))
            for k, ch in enumerate(kf.STEM_CHANNELS):
                assert torch.equal(stem[:, :, k], w[:, :, ch])
            assert sorted(kf.STEM_CHANNELS) == list(range(12))
        else:
            assert torch.equal(b, w.reshape(-1, n)), key
        assert torch.equal(b, kf.gemm_matrix(key, w)), key
    for key in kf.BIAS_KEYS:
        assert torch.equal(biases[key], packed_bf16[key])
    assert packed_bf16["mma"].dtype == torch.bfloat16
    assert packed_bf16["bias"].numel() == kf.BIAS_ELEMS


def test_front_pack_bf16_exact_flag(packed, packed_bf16):
    """bf16_exact holds for the detector in bf16 (the recognizer's plate
    model) and not in float32, whose weights bf16 fragments would round."""
    assert packed_bf16.bf16_exact is True
    assert packed.bf16_exact is False


@pytest.fixture(scope="module")
def packed_bf16_u8():
    """The bf16 detector's pack for uint8 frames: 1/255 folded into the
    stem in float32, the product rounded to bf16."""
    model = tyolo.load_plate_detector(PLATE, device="cpu")
    return kf.front_pack(model.to(torch.bfloat16), input_scale=1.0 / 255.0)


def test_front_pack_folded_stem_fragments_give_back_the_rounded_weights(
        packed_bf16, packed_bf16_u8):
    """The folded pack stores w0 as bf16(float32(w0) * float32(1/255)),
    and its B fragments give that rounded w0 back bit for bit (and every
    other layer's weights and the biases unchanged): the kernel's uint8
    instance and front_plain read the same stem."""
    w0 = packed_bf16["w0"]
    folded = (w0 * torch.tensor(1.0 / 255.0, dtype=torch.float32)
              ).to(torch.bfloat16).float()
    assert torch.equal(packed_bf16_u8["w0"], folded)
    assert not torch.equal(folded, w0)
    mats, biases = _unpacked(packed_bf16_u8)
    assert torch.equal(mats["w0"], kf.gemm_matrix("w0", folded))
    for key, _, _ in kf.MMA_LAYERS[1:]:
        assert torch.equal(packed_bf16_u8[key], packed_bf16[key]), key
        assert torch.equal(mats[key], kf.gemm_matrix(key,
                                                     packed_bf16[key])), key
    for key in kf.BIAS_KEYS:
        assert torch.equal(biases[key], packed_bf16[key])


def test_front_pack_bf16_exact_flag_after_the_fold(packed_bf16_u8):
    """bf16_exact is decided on the model's own weights, before the fold:
    True for the bf16 detector packed at input_scale=1/255, False for the
    float32 one, whose folded stem stays unrounded."""
    assert packed_bf16_u8.bf16_exact is True
    assert packed_bf16_u8.dtype == torch.bfloat16
    p32 = kf.front_pack(tyolo.load_plate_detector(PLATE, device="cpu"),
                        input_scale=1.0 / 255.0)
    assert p32.bf16_exact is False and p32.dtype == torch.float32


def _emulate_front(x, packed):
    """K1's tile pipeline (csrc/yolo_front.cu) in float32: per 8x16 output
    tile, each layer as M x K @ K x N with the kernel's row and k-step
    index maps over its shared-memory tiles (rows of 16 channels, one
    plane per chunk; the stem in four parity planes), B from the unpacked
    fragments, M padded to 16 with clamped rows."""
    mats, biases = _unpacked(packed)
    B, H, W, _ = x.shape
    h2, w2, h4, w4 = H // 2, W // 2, H // 4, W // 4
    DW, SW, ZW, PH, PW = 18, 37, 39, 11, 19
    SP, DP = 4 * PH * PW, 10 * DW

    def conv(src, npos, row, koff, key, bias):
        ksteps = mats[key].shape[0] // 16
        p = torch.arange(-(-npos // 16) * 16).clamp(max=npos - 1)
        a = torch.cat([src[row(p) + koff(s)] for s in range(ksteps)], 1)
        return (a @ mats[key] + biases[bias])[:npos]

    def planes(y, nrows, pos):
        t = torch.zeros(y.shape[1] // 16 * nrows, 16)
        for c in range(y.shape[1] // 16):
            t[c * nrows + pos] = y[:, 16 * c:16 * c + 16]
        return t

    def domain(gy, gx, h, w):
        return (((gy >= 0) & (gy < h) & (gx >= 0) & (gx < w))
                .float()[:, None])

    xp = F.pad(x.float(), (0, 0, 8, 8, 8, 8))
    out = torch.zeros(B, h4, w4, 64)
    for b in range(B):
        for r0 in range(0, h4, 8):
            for c0 in range(0, w4, 16):
                fr = xp[b, 4 * r0:4 * r0 + 46, 4 * c0:4 * c0 + 78]
                z = F.pad(fr.reshape(23, 2, ZW, 2, 3).permute(0, 2, 1, 3, 4)
                          .reshape(-1, 12), (0, 4))
                p = torch.arange(21 * SW)
                sy, sx = p // SW, p % SW
                y = conv(z, 21 * SW, lambda p: (p // SW) * ZW + p % SW,
                         lambda s: (s // 3) * ZW + s % 3, "w0", "b0")
                y = silu(y) * domain(2 * r0 - 3 + sy, 2 * c0 - 3 + sx, h2, w2)
                stem = planes(y, SP, ((2 * (sy % 2) + sx % 2) * PH + sy // 2)
                              * PW + sx // 2)

                def down_koff(s):
                    ky, kx = (s // 2) // 3, (s // 2) % 3
                    return ((s % 2) * SP + (2 * (ky % 2) + kx % 2) * PH * PW
                            + (ky // 2) * PW + kx // 2)

                p = torch.arange(DP)
                dom = domain(r0 - 1 + p // DW, c0 - 1 + p % DW, h4, w4)
                d = conv(stem, DP, lambda p: (p // DW) * PW + p % DW,
                         down_koff, "w1", "b1")
                d = planes(silu(d) * dom, DP, p)
                a = silu(conv(d, DP, lambda p: p, lambda s: s * DP, "w12",
                              "b12")) * dom
                ta = planes(a, DP, p)
                bb = silu(conv(ta, DP, lambda p: p, lambda s: s * DP, "wm1",
                               "bm1")) * dom
                bb = planes(bb, DP, p)
                interior = ((p[:128] // 16) + 1) * DW + p[:128] % 16 + 1
                m = silu(conv(bb, 128, lambda p: (p // 16) * DW + p % 16,
                              lambda s: (s % 2) * DP + ((s // 2) // 3) * DW
                              + (s // 2) % 3, "wm2", "bm2"))
                res = a[interior, :32] + m       # the shortcut, in place
                ta[interior], ta[DP + interior] = res[:, :16], res[:, 16:]
                y = silu(conv(ta, 128, lambda p: ((p // 16) + 1) * DW
                              + p % 16 + 1, lambda s: s * DP, "w3", "b3"))
                out[b, r0:r0 + 8, c0:c0 + 16] = y.reshape(8, 16, 64)
    return out


def test_implicit_gemm_emulation_matches_plain_version(packed_bf16, frames):
    """The kernel's implicit-GEMM index math (tile rows, tap and chunk
    shifts, the stem's parity planes read at stride 2, the fragment order
    of B, the clamped M rows) emulated in float32 reproduces front_plain on
    the same packed bf16 weights at (1, 64, 128) within 1e-4: both sum in
    float32 and differ only in the order of the sums."""
    x = torch.from_numpy(frames)
    got = _emulate_front(x, packed_bf16)
    ref = kf.front_plain(x, packed_bf16)
    assert got.shape == ref.shape == (1, 16, 32, 64)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4)


# Shapes K1 takes on the card: the production batch slice, the square
# detector of tools/prof_pipeline.py, the CPU tests' frame, and the least
# whole tile.
CARD_SHAPES = [(2, 736, 1280), (1, 1280, 1280), (1, 64, 128), (3, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_plain_version_on_card(shape):
    """K1 vs front_plain on the card, bf16, real weights, at each of
    CARD_SHAPES, within kf.TOL_* (0.03 + 2 bf16 ulps elementwise over the
    whole tensor, borders included; interior mean 0.004): both round at the
    same points, so only the order of the fp32 sums differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = tyolo.load_plate_detector(PLATE, device="cuda").to(torch.bfloat16)
    p = kf.front_pack(model)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((*shape, 3), generator=g, device="cuda"
                   ).to(torch.bfloat16)
    before = kf.yolo_front.launches
    got = kf.yolo_front(x, p)
    ref = kf.front_plain(x, p)
    torch.cuda.synchronize()
    assert kf.yolo_front.launches == before + 1
    max_err, ratio, interior = kf.front_errors(got, ref)
    assert ratio < 1.0, (max_err, ratio)
    assert interior < kf.TOL_INTERIOR_MEAN, interior


@pytest.mark.cuda
def test_kernel_rejects_a_pack_that_is_not_bf16_exact():
    """The float32 detector's pack holds weights that bf16 fragments would
    round: a CUDA launch with it raises ValueError and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = kf.front_pack(tyolo.load_plate_detector(PLATE, device="cuda"))
    assert p.bf16_exact is False
    x = torch.zeros((1, 32, 64, 3), dtype=torch.bfloat16, device="cuda")
    before = kf.yolo_front.launches
    with pytest.raises(ValueError):
        kf.yolo_front(x, p)
    assert kf.yolo_front.launches == before


def test_front_variants_apply_to_the_committed_source(capsys):
    """Every design variant of lpr_tpu_torch/tools/front_variants.py, K1's
    and K3's, still edits the committed kernel source (csrc/yolo_front.cu,
    csrc/yolo_mid.cu) and csrc/implicit_gemm.cuh, which both include (each
    edit names its file, each anchor found once there), and its --list
    mode runs without a card."""
    from lpr_tpu_torch.tools import front_variants as fv

    for kernel, (source, variants) in fv.KERNELS.items():
        texts = fv.sources(kernel)
        assert sorted(texts) == sorted([source.name, "implicit_gemm.cuh"])
        assert '#include "implicit_gemm.cuh"' in texts[source.name]
        for name, (_, edits) in variants.items():
            edited = fv.apply(texts, edits)
            assert (edited == texts) == (name == "base"), (kernel, name)
    texts = fv.sources()
    with pytest.raises(ValueError):
        fv.apply(texts, [("yolo_front.cu", "no such line", "")])
    with pytest.raises(ValueError):
        fv.apply(texts, [("lpsr.cu", "", "")])
    for kernel, (_, variants) in fv.KERNELS.items():
        assert fv.main(["--kernel", kernel, "--list"]) == 0
        out = capsys.readouterr().out
        assert all(name in out for name in variants)
