"""K3, the detector's layers 3-4 as one kernel: the port's packer and plain
version against the JAX package's kernel (interpret mode) and reference,
the detector hook, the wrapper's dispatch and work count, the kernel's
operand pack and implicit-GEMM index maps (emulated in float32), and (on a
card) the CUDA kernel against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lpr_tpu.ops.pallas.yolo_mid import (mid_fused, mid_geom, mid_reference,
                                         pack_mid_input, pack_mid_weights)
from lpr_tpu_torch.kernels import yolo_front as kf
from lpr_tpu_torch.kernels import yolo_mid as km
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.ops.nn import silu

from .test_pallas_mid import _rand_params
from .test_torch_front import _unpack_frags
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


@pytest.fixture(scope="module")
def packed_bf16():
    """The pack of the detector in bf16, whose weights the kernel's bf16
    fragments hold exactly."""
    model = tyolo.load_plate_detector(PLATE, device="cpu")
    return km.mid_pack(model.to(torch.bfloat16))


def _unpacked(packed):
    """Each layer's K x N matrix and bias from packed["mma"] and
    packed["bias"], read as the kernel's lanes read the fragments."""
    mats, off = {}, 0
    for key, ksteps, n in km.MMA_LAYERS:
        size = 16 * ksteps * n
        mats[key] = _unpack_frags(packed["mma"][off:off + size], ksteps, n)
        off += size
    assert off == packed["mma"].numel() == km.MMA_ELEMS
    sizes = [packed[k].numel() for k in km.BIAS_KEYS]
    biases = dict(zip(km.BIAS_KEYS, torch.split(packed["bias"], sizes)))
    return mats, biases


def test_mid_pack_b_fragments_give_back_the_weights(packed_bf16):
    """The bf16 B fragments, unpacked on the CPU by the PTX fragment
    definition, are the float32 weights bit for bit with K over (tap,
    chunk, channel); the biases follow BIAS_KEYS."""
    mats, biases = _unpacked(packed_bf16)
    for key, ksteps, n in km.MMA_LAYERS:
        b = mats[key]
        assert not torch.isnan(b).any(), key
        assert b.shape == (16 * ksteps, n)
        assert torch.equal(b, packed_bf16[key].reshape(-1, n)), key
    assert torch.equal(mats["w3"].reshape(3, 3, 64, 128), packed_bf16["w3"])
    for key in km.BIAS_KEYS:
        assert torch.equal(biases[key], packed_bf16[key])
    assert packed_bf16["mma"].dtype == torch.bfloat16
    assert packed_bf16["bias"].dtype == torch.float32
    assert packed_bf16["bias"].numel() == km.BIAS_ELEMS


def test_mid_pack_bf16_exact_flag(packed_bf16):
    """bf16_exact holds for the detector in bf16 and for folded weights
    rounded to bf16, not for the float32 detector or float32 folded
    weights, which bf16 fragments would round."""
    assert packed_bf16.bf16_exact is True
    model = tyolo.load_plate_detector(PLATE, device="cpu")
    assert km.mid_pack(model).bf16_exact is False
    p_l3, p_c3 = _rand_params(np.random.RandomState(3))
    assert km.mid_pack_folded(p_l3, p_c3).bf16_exact is False

    def bf16(tree):
        if isinstance(tree, dict):
            return {k: bf16(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [bf16(v) for v in tree]
        return torch.from_numpy(tree).to(torch.bfloat16).float()

    assert km.mid_pack_folded(bf16(p_l3), bf16(p_c3)).bf16_exact is True


def _emulate_mid(y, packed):
    """K3's tile pipeline (csrc/yolo_mid.cu) in float32: per 8x16 output
    tile, one shared-memory image of 32-byte rows (16 channels a row, one
    plane of rows per chunk) holding the kernel's regions at the kernel's
    offsets; each layer as M x K @ K x N with the kernel's row and k-step
    index maps, B from the unpacked fragments, M padded to whole m-tiles
    with clamped rows that the epilogue writes too.  Every layer's rows
    read (A and residual) and written are checked to be disjoint, which
    is what lets the kernel's warps run a layer in any order."""
    mats, biases = _unpacked(packed)
    B, H4, W4, _ = y.shape
    h8, w8 = H4 // 2, W4 // 2
    LW, PH, PW = 20, 13, 21
    IP, LP = 4 * PH * PW, 240
    Y, T, A = 0, 8 * LP, 4 * IP          # region offsets in rows
    tiles_y, tiles_x = -(-h8 // 8), -(-w8 // 16)
    yp = F.pad(y.float(), (0, 0, 5, 32 * tiles_x + 4 - W4, 5,
                           16 * tiles_y + 4 - H4))
    out = torch.zeros(B, h8, w8, 128)

    def conv(S, npos, mt, row, koff, key, bias):
        ksteps = mats[key].shape[0] // 16
        nmt = -(-npos // 16)
        p = torch.arange(-(-nmt // mt) * mt * 16).clamp(max=npos - 1)
        rows = [row(p) + koff(s) for s in range(ksteps)]
        a = torch.cat([S[r] for r in rows], 1)
        return p, (a @ mats[key] + biases[bias]), torch.cat(rows)

    def store(S, base, q, v):
        for c in range(v.shape[1] // 16):
            S[base + c * LP + q] = v[:, 16 * c:16 * c + 16]
        return torch.cat([base + c * LP + q for c in range(v.shape[1] // 16)])

    def disjoint(read, written):
        assert not set(read.tolist()) & set(written.tolist())

    inner = lambda p: (p // 18 + 1) * LW + p % 18 + 1       # noqa: E731
    central = lambda p: (p // 16 + 2) * LW + p % 16 + 2     # noqa: E731

    def tap3x3(s):
        t = s // 4
        return (s % 4) * LP + (t // 3) * LW + t % 3

    for b in range(B):
        for r0 in range(0, h8, 8):
            for c0 in range(0, w8, 16):
                S = torch.full((A + 8 * LP, 16), float("nan"))
                # the input window, rows 2*r0-5.., cols 2*c0-5.., as planes
                win = yp[b, 2 * r0:2 * r0 + 25, 2 * c0:2 * c0 + 41]
                iy, ix = torch.meshgrid(torch.arange(25), torch.arange(41),
                                        indexing="ij")
                prow = (((2 * (iy % 2) + ix % 2) * PH + iy // 2) * PW
                        + ix // 2).reshape(-1)
                for c in range(4):
                    S[c * IP + prow] = win.reshape(-1, 64)[:, 16 * c:16 * c
                                                           + 16]
                q12 = torch.arange(LP)
                dom = ((r0 - 2 + q12 // LW >= 0) & (r0 - 2 + q12 // LW < h8)
                       & (c0 - 2 + q12 % LW >= 0) & (c0 - 2 + q12 % LW < w8)
                       ).float()[:, None]

                def l3_koff(s):
                    ky, kx = (s // 4) // 3, (s // 4) % 3
                    return ((s % 4) * IP + (2 * (ky % 2) + kx % 2) * PH * PW
                            + (ky // 2) * PW + kx // 2)

                p, v, rd = conv(S, LP, 2, lambda p: (p // LW) * PW + p % LW,
                                l3_koff, "w3", "b3")
                disjoint(rd, store(S, A, p, silu(v) * dom[p]))
                p, v, rd = conv(S, LP, 4, lambda p: A + p,
                                lambda s: s * LP, "w12", "b12")
                disjoint(rd, store(S, Y, p, silu(v) * dom[p]))
                p, v, rd = conv(S, LP, 2, lambda p: Y + p,
                                lambda s: s * LP, "wa1", "ba1")
                disjoint(rd, store(S, T, p, silu(v) * dom[p]))
                # bottleneck 0's m.cv2: m0 = silu + cv1 (y) -> a
                p, v, rd = conv(S, 180, 3,
                                lambda p: T + (p // 18) * LW + p % 18,
                                tap3x3, "wa2", "ba2")
                q = inner(p)
                res = torch.cat([S[Y + c * LP + q] for c in range(4)], 1)
                wr = store(S, A, q, (silu(v) + res) * dom[q])
                disjoint(torch.cat([rd, Y + q]), wr)
                p, v, rd = conv(S, 180, 3, lambda p: A + inner(p),
                                lambda s: s * LP, "wb1", "bb1")
                q = inner(p)
                disjoint(rd, store(S, T, q, silu(v) * dom[q]))
                # bottleneck 1's m.cv2: m1 = silu + m0 (a) -> y's cv1 half
                p, v, rd = conv(S, 128, 2,
                                lambda p: T + (p // 16 + 1) * LW + p % 16 + 1,
                                tap3x3, "wb2", "bb2")
                q = central(p)
                res = torch.cat([S[A + c * LP + q] for c in range(4)], 1)
                disjoint(torch.cat([rd, A + q]),
                         store(S, Y, q, silu(v) + res))
                p, v, rd = conv(S, 128, 2, lambda p: Y + central(p),
                                lambda s: s * LP, "w3o", "b3o")
                o = silu(v)[:128].reshape(8, 16, 128)
                rows, cols = min(8, h8 - r0), min(16, w8 - c0)
                out[b, r0:r0 + rows, c0:c0 + cols] = o[:rows, :cols]
    return out


def test_implicit_gemm_emulation_matches_plain_version(packed_bf16):
    """The kernel's implicit-GEMM index math (the input's parity planes
    read at stride 2, tile rows, tap shifts in the 20-wide buffers, the
    regions' reuse, clamped padding rows, b0's m.cv2 residual rows, the
    fragment order of B) emulated in float32 reproduces mid_plain on the
    same packed bf16 weights within 1e-4 at a (1, 20, 36, 64) front grid,
    whose 10 x 18 output leaves a ragged tile in both axes: both sum in
    float32 and differ only in the order of the sums."""
    y = torch.from_numpy(np.random.RandomState(4).rand(1, 20, 36, 64)
                         .astype(np.float32))
    got = _emulate_mid(y, packed_bf16)
    ref = km.mid_plain(y, packed_bf16)
    assert got.shape == ref.shape == (1, 10, 18, 128)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4)


# K3's inputs on the card: K1's output for the production batch slice and
# for the square detector of tools/prof_pipeline.py, a random front grid
# with a ragged tile in both axes, and one whole tile.
CARD_CASES = [("front", (2, 736, 1280)), ("front", (1, 1280, 1280)),
              ("random", (3, 20, 36, 64)), ("random", (1, 16, 32, 64))]


@pytest.mark.cuda
@pytest.mark.parametrize("source,shape", CARD_CASES)
def test_kernel_matches_plain_version_on_card(source, shape):
    """K3 vs mid_plain on the card, bf16, real weights, on K1's output for
    frames of ``shape`` or on a random front output of ``shape``, within
    km.TOL_* (0.05 + 2 bf16 ulps elementwise, interior mean 0.006)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = tyolo.load_plate_detector(PLATE, device="cuda").to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    if source == "front":
        x = torch.rand((*shape, 3), generator=g, device="cuda"
                       ).to(torch.bfloat16)
        y = kf.yolo_front(x, kf.front_pack(model))
    else:
        y = torch.rand(shape, generator=g, device="cuda").to(torch.bfloat16)
    p = km.mid_pack(model)
    before = km.yolo_mid.launches
    got = km.yolo_mid(y, p)
    ref = km.mid_plain(y, p)
    torch.cuda.synchronize()
    assert km.yolo_mid.launches == before + 1
    assert got.shape == (y.shape[0], y.shape[1] // 2, y.shape[2] // 2, 128)
    assert torch.isfinite(got.float()).all()
    max_err, ratio, interior = km.mid_errors(got, ref)
    assert ratio < 1.0, (max_err, ratio)
    assert interior < km.TOL_INTERIOR_MEAN, interior


@pytest.mark.cuda
def test_kernel_rejects_a_pack_that_is_not_bf16_exact():
    """The float32 detector's pack holds weights that bf16 fragments would
    round: a CUDA launch with it raises ValueError and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = km.mid_pack(tyolo.load_plate_detector(PLATE, device="cuda"))
    assert p.bf16_exact is False
    y = torch.zeros((1, 16, 32, 64), dtype=torch.bfloat16, device="cuda")
    before = km.yolo_mid.launches
    with pytest.raises(ValueError):
        km.yolo_mid(y, p)
    assert km.yolo_mid.launches == before
