"""The int8 detector (PipelineConfig.int8_detector) and the eager-decode NMS
path (lazy_decode=False) of the port against the JAX package, on the CPU;
the int8 kernels' operand pack and implicit-GEMM index maps emulated in
numpy; and, on a card, kernels I1 and I2 against their plain versions.

The int8 weights come from the same float32 numpy arithmetic on both sides
(BN folded by the same formula, then quantize_conv_weight), so they are
compared byte for byte.  An int8 convolution's int32 sums are exact on
both sides (the port's plain version sums in float64), so with equal float
inputs conv2d_int8 is equal bit for bit.  Through a detector the inputs of
later int8 layers carry the float32 rounding of the layers before them
(oneDNN and XLA sum in different orders); that moves an activation code
only where x / sx lies within a float32 rounding of a .5 tie."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.models import yolo as jyolo
from lpr_tpu.models.lpsr import LPSRConfig as JLPSRConfig
from lpr_tpu.ops import nn as jnn
from lpr_tpu.pipeline import recognizer as jrec
from lpr_tpu_torch.kernels import conv_int8 as ki
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.ops import nn as tnn
from lpr_tpu_torch.ops.nms import nms_batched, nms_from_raw
from lpr_tpu_torch.pipeline import recognizer as trec
from lpr_tpu_torch.weights.checkpoint import params_from_jax

from .test_torch_recognizer import synth_frames
from .test_torch_zoo import npz_params, rand_params
from .torch_ref import CHAR, LPSR, PLATE


@functools.lru_cache(maxsize=None)
def _jax_models():
    """(plate model, params), (char model, params, names), LPSR params: the
    repo's checkpoints in the JAX package's models, as tests/torch_ref.py
    loads them, without running their inits."""
    from lpr_tpu.models.lpsr import lpsr_init
    from lpr_tpu.pipeline.chars import OCR_CLASSES

    plate = jyolo.build_yolo(jyolo.yolov5_spec(nc=11), strides=(8, 16, 32))
    anchors = np.asarray(np.load(CHAR)["__anchors__"], np.float32)
    char = jyolo.build_yolo(jyolo.char_ocr_spec(), ckpt_anchors=anchors,
                            strides=(8,))
    return ((plate, npz_params(PLATE, plate)),
            (char, npz_params(CHAR, char), list(OCR_CLASSES)),
            npz_params(LPSR, lpsr_init, JLPSRConfig()))


def _jax_quantized(tree, path=()):
    """{checkpoint path: quantized dict} of a quantize_yolo output."""
    out = {}
    if isinstance(tree, dict):
        if "w_q" in tree:
            return {"/".join(path): tree}
        for k, v in tree.items():
            out.update(_jax_quantized(v, path + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_jax_quantized(v, path + (str(i),)))
    return out


def _n_convs(tree) -> int:
    """Convolutions (4-D weights, float or int8) in a params pytree."""
    if isinstance(tree, dict):
        if "w_q" in tree or ("w" in tree and np.ndim(tree["w"]) == 4):
            return 1
        return sum(_n_convs(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_n_convs(v) for v in tree)
    return 0


@pytest.mark.parametrize("case", ["normal", "zero channel", "wide range"])
def test_quantize_conv_weight_matches_jax(case):
    """Byte for byte on the int8 codes; the scales within one float32 ulp
    (both divide amax by 127 in float32)."""
    rng = np.random.RandomState(len(case))
    w = (rng.randn(3, 3, 24, 40) * 0.05).astype(np.float32)
    if case == "zero channel":
        w[..., 3] = 0.0
    elif case == "wide range":
        w *= np.exp(rng.randn(40) * 3).astype(np.float32)
    jq, js = jnn.quantize_conv_weight(jnp.asarray(w))
    tq, ts = tnn.quantize_conv_weight(w)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tq, np.asarray(jq))
    np.testing.assert_array_max_ulp(ts, np.asarray(js), maxulp=1)


@pytest.fixture(scope="module")
def yolov5n_random():
    """A random yolov5n (nc=11) in the JAX init's structure, with random
    batch norms (:func:`rand_params`), and the port's model from the same
    weights."""
    jm = jyolo.build_yolo(jyolo.yolov5_spec(nc=11, depth=0.33, width=0.25),
                          strides=(8, 16, 32))
    jp = rand_params(jm)
    tm = tyolo.yolov5("n", nc=11).load_state(params_from_jax(jp))
    return jm, jp, tm


@pytest.mark.parametrize("which", ["plate_det640", "random yolov5n"])
def test_quantize_yolo_matches_jax(which, yolov5n_random):
    """The same set of quantized convs (for yolov5s 55 of its 60: the
    Detect head's three, the S2D stem and layer 2's 32-channel 1x1 stay
    float), equal int8 codes byte for byte, scales within one ulp, equal
    biases."""
    if which == "plate_det640":
        jm, jp = _jax_models()[0]
        tm = tyolo.load_plate_detector(PLATE, device="cpu")
        jq = _jax_quantized(_jax_int8_plate(False))
    else:
        jm, jp, _ = yolov5n_random
        tm = tyolo.yolov5("n", nc=11).load_state(params_from_jax(jp))
        jq = _jax_quantized(jyolo.quantize_yolo(jm, jp))
    tyolo.quantize_yolo(tm)
    tq = tyolo.quantized_convs(tm)
    assert sorted(tq) == sorted(jq)
    if which == "plate_det640":
        assert (len(jq), _n_convs(jp)) == (55, 60)
    for path, d in jq.items():
        conv = tq[path]
        np.testing.assert_array_equal(conv.w_q.numpy(), np.asarray(d["w_q"]))
        np.testing.assert_array_max_ulp(
            conv.w_s_bits.view(torch.float32).numpy(), np.asarray(d["w_s"]),
            maxulp=1)
        if "b" in d:
            np.testing.assert_array_equal(
                conv.b_bits.view(torch.float32).numpy(), np.asarray(d["b"]))
    # idempotent: a second quantize keeps the codes
    before = {k: v.w_q.clone() for k, v in tq.items()}
    tyolo.quantize_yolo(tm)
    assert all(torch.equal(before[k], v.w_q)
               for k, v in tyolo.quantized_convs(tm).items())


def _planned_model(which, yolov5n_random):
    """(quantized port model, its detector input, the layer it starts at):
    plate_det640 from the frames (layers 0-2 int8 too, as on the CPU
    without fused_front) or after K1's plain version (layer 3, the card's
    path), or the random yolov5n."""
    from lpr_tpu_torch.kernels.yolo_front import front_pack, front_plain

    x = torch.from_numpy(np.random.RandomState(0).rand(2, 128, 256, 3)
                         .astype(np.float32))
    if which == "random yolov5n":
        _, jp, _ = yolov5n_random
        tm = tyolo.yolov5("n", nc=11).load_state(params_from_jax(jp))
        return tyolo.quantize_yolo(tm), x, 0
    tm = tyolo.load_plate_detector(PLATE, device="cpu")
    if which == "plate_det640":
        return tyolo.quantize_yolo(tm), x, 0
    front = front_pack(tm)
    tyolo.quantize_yolo(tm)
    with torch.inference_mode():
        return tm, front_plain(x, front), 3


def _unplanned_head(tm, y, start):
    """The layers from ``start`` as forward_from runs them, but outside a
    planned forward: every quantize takes its own max pass."""
    saved, n = {start - 1: y}, len(tm.layers)
    for l in tm.layers[start:]:
        if l.f != -1:
            y = (saved[l.f % n] if isinstance(l.f, int) else
                 [y if j == -1 else saved[j % n] for j in l.f])
        y = l(y)
        if l.i in tm.save:
            saved[l.i] = y
    return y


@pytest.mark.parametrize("which", ["plate_det640", "plate_det640 after K1",
                                   "random yolov5n"])
def test_amax_plan_carries_each_inputs_exact_max(which, yolov5n_random,
                                                 monkeypatch):
    """plan_amax on the int8 detector (C3s with shortcuts, SPPF, the head's
    upsample and concats), through the plain versions in float32: every
    quantize that reads slots gets max(slots) equal to x.abs().amax() of
    the tensor it quantizes, bit for bit; after K1 (layer 3 on) yolov5s
    takes one max pass (K1's output), 43 quantizes and 50 int8 convs."""
    tm, y, start = _planned_model(which, yolov5n_random)
    seen = {"quantize": 0, "planned": 0, "amax": 0, "conv": 0,
            "conv amax": 0}
    quantize, act_amax, conv = ki.quantize_act, ki.act_amax, ki.conv_int8

    def q(x, slots=None):
        seen["quantize"] += 1
        if slots is not None:
            seen["planned"] += 1
            got = torch.stack([t.reshape(()) for t in slots]).amax()
            ref = x.float().abs().amax()
            assert got.view(torch.int32) == ref.view(torch.int32), (
                tuple(x.shape), got.item(), ref.item())
        return quantize(x, slots)

    def a(x, slot):
        seen["amax"] += 1
        return act_amax(x, slot)

    def c(*args, amax=None, **kw):
        seen["conv"] += 1
        seen["conv amax"] += amax is not None
        return conv(*args, amax=amax, **kw)

    monkeypatch.setattr(ki, "quantize_act", q)
    monkeypatch.setattr(ki, "act_amax", a)
    monkeypatch.setattr(ki, "conv_int8", c)
    with torch.inference_mode():
        tm.forward_from(y, start)
    max_passes = seen["amax"] - seen["conv amax"]
    assert seen["planned"] == seen["quantize"] > 0
    assert seen["conv"] == sum(
        1 for m in tm.modules() if isinstance(m, tyolo.ConvAct)
        and m.quantized and int(m.prefix.split("/")[0]) >= start)
    if which == "plate_det640 after K1":
        assert (max_passes, seen["quantize"], seen["conv"]) == (1, 43, 50)
    assert max_passes < seen["quantize"] // 4


@pytest.mark.parametrize("which", ["plate_det640", "plate_det640 after K1",
                                   "random yolov5n"])
def test_int8_head_with_the_amax_plan_equals_the_head_without(
        which, yolov5n_random):
    """The int8 detector's raw head through forward_from (the plan's
    carried maxima, the shared C3 quantize, the fused activation and
    shortcut) equals, bit for bit, the same layers run outside a planned
    forward (each quantize its own max pass), in float32 on the CPU."""
    tm, y, start = _planned_model(which, yolov5n_random)
    with torch.inference_mode():
        got = tm.forward_from(y, start)
        ref = _unplanned_head(tm, y, start)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# (batch, H, W, Cin, Cout, k, stride): strides 1 and 2, k 1 and 3, Cin 16,
# 64 and 512, and K = 3 * 3 * 512 = 4,608 > 1,040, where float32 sums of
# the codes would round.
CONV_CASES = [(2, 11, 13, 16, 24, 3, 2), (2, 12, 10, 64, 32, 1, 1),
              (1, 9, 9, 64, 48, 3, 1), (1, 6, 8, 512, 40, 3, 2),
              (1, 7, 5, 512, 16, 1, 1)]


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv2d_int8_matches_jax(case):
    """conv2d_int8 equal to JAX's bit for bit on the same float32 inputs
    (the activation codes and sx too), and within the JAX test's 2 % of
    max against the float conv (tests/test_yolo.py:390-403)."""
    B, H, W, cin, cout, k, s = case
    rng = np.random.RandomState(cin + cout + k)
    x = rng.randn(B, H, W, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) * 0.05).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    jwq, jws = jnn.quantize_conv_weight(jnp.asarray(w))
    ref = np.asarray(jnn.conv2d_int8(jnp.asarray(x), jwq, jws, jnp.asarray(b),
                                     stride=s, padding="same"))
    wq, ws = tnn.quantize_conv_weight(w)
    xt = torch.from_numpy(x)
    got = tnn.conv2d_int8(xt, torch.from_numpy(wq), torch.from_numpy(ws),
                          torch.from_numpy(b), stride=s, padding="same")
    # the activation codes as the JAX function makes them
    sx = np.maximum(np.abs(x).max() / np.float32(127.0), np.float32(1e-12))
    xq, tsx = ki.quantize_act_plain(xt)
    assert xq.shape == (B, H, W, ki.padded_channels(cin))
    assert tsx.item() == np.float32(sx)
    jxq = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / jnp.float32(sx)),
                              -127, 127).astype(jnp.int8))
    np.testing.assert_array_equal(xq[..., :cin].numpy(), jxq)
    assert not xq[..., cin:].any()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    fl = np.asarray(jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=s, padding="same"))
    assert np.abs(got.numpy() - fl).max() / np.abs(fl).max() < 0.02


def _swizzle(off: np.ndarray, row_bytes: int) -> np.ndarray:
    """Byte offsets in the swizzle of width row_bytes (32, 64 or 128; the
    tile 1024-byte aligned): the 16-byte chunk index XOR the row's index in
    its group of 8, taken from the address."""
    return off ^ (((off >> 7) & (row_bytes // 16 - 1)) << 4)


def _wgmma_reads(rows: int, row_bytes: int, kk: int) -> np.ndarray:
    """Byte offsets (rows, 32) at which a wgmma descriptor of a K-major
    operand of rows of row_bytes, the swizzle of that width, SBO 8 rows,
    started at k-step kk (32 kk bytes into the tile), reads element (row
    r, k): the canonical layout ((8, m), (16, 2)) : ((row_bytes, 8
    row_bytes), (1, 16)) bytes from the start address, then the swizzle on
    the address."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return _swizzle((r // 8) * 8 * row_bytes + (r % 8) * row_bytes
                    + 32 * kk + k, row_bytes)


def _emulate_i2(xq, w_q, pack, stride, pad, bn):
    """I2's tile walk in numpy: per block (a tile of th x tw output
    positions of one image, :func:`ki.tile_shape`, by bn channels) and
    k-stage (a tap and k_stage(Cp) channels: rows of rb bytes), the A box
    that TMA writes (the tile's input positions at the tap, every
    stride-th, zeros off the image; row yy * tw + xx) and the weight's
    boxes (64 rows x rb bytes of int8_pack's K-major matrix), both in the
    swizzle of width rb, read back k-step by k-step through the wgmma
    descriptors (:func:`_wgmma_reads`) and multiplied in int64; rows past
    the tile or the image dropped: the int32 sums."""
    B, H, W, cp = xq.shape
    kh, kw, cin, cout = w_q.shape
    ho = (H + 2 * pad[0] - kh) // stride + 1
    wo = (W + 2 * pad[1] - kw) // stride + 1
    tw, th = ki.tile_shape(ho, wo, stride)
    rb = ki.k_stage(cp)
    swz_a = _swizzle(np.arange(ki.BM * rb).reshape(ki.BM, rb), rb)
    swz_b = _swizzle(np.arange(bn * rb).reshape(bn, rb), rb)
    yy, xx = np.divmod(np.arange(tw * th), tw)
    out = np.zeros((B, ho, wo, -(-cout // bn) * bn), np.int64)
    for nb in range(B):
        for ty in range(-(-ho // th)):
            for tx in range(-(-wo // tw)):
                oy, ox = ty * th + yy, tx * tw + xx
                for n0 in range(0, out.shape[-1], bn):
                    acc = np.zeros((ki.BM, bn), np.int64)
                    for ks in range(kh * kw * cp // rb):
                        tap, c0 = divmod(ks, cp // rb)
                        c0 *= rb
                        dy, dx = divmod(tap, kw)
                        iy = oy * stride - pad[0] + dy
                        ix = ox * stride - pad[1] + dx
                        ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
                        box = np.zeros((ki.BM, rb), np.int8)
                        box[:tw * th][ok] = xq[nb, iy[ok], ix[ok],
                                               c0:c0 + rb]
                        sa = np.zeros(ki.BM * rb, np.int8)
                        sa[swz_a] = box
                        sb = np.zeros(bn * rb, np.int8)
                        sb[swz_b] = pack[n0:n0 + bn,
                                         tap * cp + c0:tap * cp + c0 + rb]
                        for kk in range(rb // 32):
                            acc += (sa[_wgmma_reads(ki.BM, rb, kk)]
                                    .astype(np.int64)
                                    @ sb[_wgmma_reads(bn, rb, kk)]
                                    .astype(np.int64).T)
                    keep = (oy < ho) & (ox < wo)
                    out[nb, oy[keep], ox[keep], n0:n0 + bn] = \
                        acc[:tw * th][keep]
    return out[..., :cout]


@pytest.mark.parametrize("case", [(2, 9, 11, 16, 24, 3, 2, 64),
                                  (1, 8, 6, 80, 72, 5, 1, 64),
                                  (1, 5, 7, 40, 130, 1, 1, 64),
                                  (1, 6, 7, 256, 136, 3, 2, 128)])
def test_i2_emulation_matches_plain_version(case):
    """I2's index maps (the padded channels, int8_pack's K-major matrix
    padded to 128 rows, k-stages of 32, 64 or 128 channels of a tap in the
    swizzle of that width, spatial tiles read as strided TMA boxes with
    zeros off the image, both operands read back k-step by k-step through
    the wgmma descriptors, N tiles of 64 and 128) reproduce conv_int8_plain's
    int32 sums exactly, with Cout ragged against the tiles, Cin against the
    k-steps and the image against the spatial tiles; and the pack holds the
    HWIO weight."""
    B, H, W, cin, cout, k, s, bn = case
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.randn(B, H, W, cin).astype(np.float32))
    wq, ws = tnn.quantize_conv_weight(
        (rng.randn(k, k, cin, cout) * 0.05).astype(np.float32))
    xq, sx = ki.quantize_act(x)
    pad = (k // 2, k // 2)
    ref = ki.conv_int8(xq, sx, torch.from_numpy(wq), torch.from_numpy(ws),
                       None, stride=(s, s), padding=pad, raw=True)
    pack = ki.int8_pack(wq).numpy()
    cp = ki.padded_channels(cin)
    assert pack.shape == (-(-cout // ki.N_PAD) * ki.N_PAD, k * k * cp)
    hwio = pack[:cout].reshape(cout, k, k, cp).transpose(1, 2, 3, 0)
    np.testing.assert_array_equal(hwio[:, :, :cin], wq)
    assert not hwio[:, :, cin:].any() and not pack[cout:].any()
    got = _emulate_i2(xq.numpy(), wq, pack, s, pad, bn)
    assert ref.dtype == torch.int32
    np.testing.assert_array_equal(got, ref.numpy())


@functools.lru_cache(maxsize=None)
def _jax_int8_plate(fused_front: bool):
    """quantize_yolo of plate_det640's JAX params (once a process: it runs
    op by op); with fused_front, layers 0-2 put back to the float params,
    which is what the JAX recognizer runs on a TPU."""
    jm, jp = _jax_models()[0]
    qp = jyolo.quantize_yolo(jm, jp)
    return list(jp[:3]) + list(qp[3:]) if fused_front else qp


def _jax_head(jm, params, x):
    return [np.asarray(r) for r in jax.jit(
        lambda p, v: jm.apply(p, v, decode=False))(params, jnp.asarray(x))]


def test_int8_detector_layers_match_jax_on_jax_inputs():
    """plate_det640 int8 (every eligible conv, as JAX runs it on the CPU)
    at (2, 128, 256), float32, layer by layer, each port layer fed the JAX
    layer's own input: within 1e-5 (the int8 sums and the epilogue are
    exact; the float parts round in another order), except where a code
    flips at a rounding tie of x / sx inside a layer (a C3 quantizes its
    own SiLU outputs, which differ by an ulp): at most 1 % of a layer's
    values beyond 1e-5 (one flip moves up to kh * kw * Cout values; a
    wrong weight, scale, bias, stride or pad would move nearly all)."""
    jm, _ = _jax_models()[0]
    qp = _jax_int8_plate(False)
    tm = tyolo.quantize_yolo(tyolo.load_plate_detector(PLATE, device="cpu"))
    y = jnp.asarray(np.random.RandomState(0).rand(2, 128, 256, 3)
                    .astype(np.float32))
    saved, n = {}, len(jm.layers)
    for lj, pj, lt in zip(jm.layers, qp, tm.layers):
        if isinstance(lj, jyolo.Detect):
            break
        if lj.f != -1:
            y = (saved[lj.f % n] if isinstance(lj.f, int) else
                 [y if j == -1 else saved[j % n] for j in lj.f])
        inp = ([torch.from_numpy(np.asarray(v)) for v in y]
               if isinstance(y, list) else torch.from_numpy(np.asarray(y)))
        y = jax.jit(lambda p, v, l=lj: l(p, v))(pj, y)
        with torch.inference_mode():
            got = lt(inp).numpy()
        err = np.abs(got - np.asarray(y))
        assert (err > 1e-5).mean() <= 0.01, (lj.i, type(lt).__name__,
                                             err.max())
        if lj.i in jm.save:
            saved[lj.i] = y


@pytest.mark.parametrize("fused_front", [False, True])
def test_int8_detector_raw_head_matches_jax(fused_front):
    """plate_det640 int8 at (2, 128, 256), float32, end to end.
    fused_front=False: every eligible layer int8, as JAX runs it on the
    CPU.  fused_front=True: layers 0-2 through K1's plain version from the
    float weights and int8 after them, against JAX applying quantize_yolo's
    output with layers 0-2 put back to the float params.

    The two int8 paths compute the same function layer by layer (the test
    above), but not bit for bit: a code that flips at a rounding tie
    changes the next layer's input by a quantization step, and from there
    codes flip wherever the inputs moved.  On this seed the first int8
    layer's codes all agree; the divergence starts in layer 2.  So the
    bound is the int8 path's own noise: the mean error below the mean
    difference between JAX's int8 and float heads, the largest below 0.5
    on logits up to ~20 (measured 0.14-0.21, against JAX's int8-vs-float
    0.19-0.24)."""
    from lpr_tpu_torch.kernels.yolo_front import front_pack

    jm, jp = _jax_models()[0]
    x = np.random.RandomState(0).rand(2, 128, 256, 3).astype(np.float32)
    ref = _jax_head(jm, _jax_int8_plate(fused_front), x)
    noise = _jax_head(jm, jp, x)
    tm = tyolo.quantize_yolo(tyolo.load_plate_detector(PLATE, device="cpu"))
    front = front_pack(tm) if fused_front else None
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), front=front)
    for g, r, f in zip(got, ref, noise):
        assert tuple(g.shape) == r.shape
        err = np.abs(g.numpy() - r)
        assert err.max() < 0.5
        assert err.mean() < np.abs(r - f).mean()


def _jax_recognizer(det_hw, plate_params=None, **cfg_kw):
    (plate, pp), (char, cp, names), lp = _jax_models()
    return jrec.PlateRecognizer(
        plate, pp if plate_params is None else plate_params, char, cp,
        lp, JLPSRConfig(),
        jrec.PipelineConfig(det_hw=det_hw, dtype=jnp.float32, **cfg_kw),
        char_names=names)


def _port_recognizer(det_hw, **cfg_kw):
    tchar, _, ck = tyolo.load_char_ocr_npz(CHAR, device="cpu")
    names = ck.names
    return trec.PlateRecognizer(
        tyolo.load_plate_detector(PLATE, device="cpu"), tchar,
        tlpsr.load_lpsr(LPSR, device="cpu"),
        trec.PipelineConfig(det_hw=det_hw, dtype=torch.float32, **cfg_kw),
        char_names=names, device="cpu")


def _box_iou(a, b):
    iw = np.clip(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]),
                 0, None)
    ih = np.clip(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]),
                 0, None)
    inter = iw * ih
    area = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
            + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))
    return inter / (area - inter)


@pytest.fixture(scope="module")
def frames():
    return synth_frames(2, (180, 320), seed=3)


@pytest.mark.parametrize("fused_front", [False, True])
def test_int8_recognizer_matches_jax(fused_front, frames):
    """The recognizer with int8_detector at det (192, 320), float32, on the
    slice test's two synthetic frames, against the JAX recognizer with
    quantize_yolo's params (what its int8_detector builds on the CPU; with
    fused_front, layers 0-2 float, the TPU path): plate_valid and classes
    equal, each plate the same detection (IoU >= 0.5, the detection
    matching threshold).  Boxes and strings are not held to the float
    slice's 0.5 px: the int8 noise of the previous test moves a box's
    score and coordinates, and with fused_front=False one plate's kept
    candidate changes (8.6 px, IoU 0.81, against JAX's int8 box; JAX's
    int8 moves it 0.95 px from the float one), and the strings follow the
    crops.  With fused_front (the card's path) the JAX test's outer bound
    holds: within 6 px of the float recognizer (tests/test_pipeline.py:
    238-262); measured 0.54 px against JAX's int8 boxes."""
    det_hw = (192, 320)
    jr = _jax_recognizer(det_hw, plate_params=_jax_int8_plate(fused_front))
    tr = _port_recognizer(det_hw, int8_detector=True, fused_front=fused_front)
    assert len(tyolo.quantized_convs(tr.plate_model)) == 55
    jo = jax.device_get(jr.step_raw(jnp.asarray(frames)))
    to = trec.to_host(tr.step_raw(frames))
    valid = jo["plate_valid"]
    assert valid.any(), "the frames must hold detectable plates"
    np.testing.assert_array_equal(to["plate_valid"], valid)
    np.testing.assert_array_equal(to["plate_classes"], jo["plate_classes"])
    assert _box_iou(to["plate_boxes"][valid],
                    jo["plate_boxes"][valid]).min() >= 0.5
    if fused_front:
        tf = trec.to_host(_port_recognizer(det_hw).step_raw(frames))
        np.testing.assert_array_equal(tf["plate_valid"], valid)
        assert np.abs(tf["plate_boxes"][valid]
                      - to["plate_boxes"][valid]).max() < 6.0


def test_eager_decode_recognizer_matches_jax_and_lazy_step(frames):
    """lazy_decode=False (Detect decode + nms_batched for plates and chars)
    at det (192, 320), float32: the JAX eager-decode step's plate_valid,
    classes, boxes within 0.5 px and strings; and the port's lazy step's
    boxes, scores and char boxes within tests/test_yolo.py:163-195's
    1e-3."""
    det_hw = (192, 320)
    jr = _jax_recognizer(det_hw, lazy_decode=False)
    tr = _port_recognizer(det_hw, lazy_decode=False)
    jo = jax.device_get(jr.step_raw(jnp.asarray(frames)))
    to = trec.to_host(tr.step_raw(frames))
    valid = jo["plate_valid"]
    assert valid.any(), "the frames must hold detectable plates"
    np.testing.assert_array_equal(to["plate_valid"], valid)
    np.testing.assert_array_equal(to["plate_classes"], jo["plate_classes"])
    np.testing.assert_allclose(to["plate_boxes"][valid],
                               jo["plate_boxes"][valid], rtol=0, atol=0.5)
    key = [[(p["text"], p["text_sr"], p["class_id"]) for p in f]
           for f in tr.assemble(to)]
    assert key == [[(p["text"], p["text_sr"], p["class_id"]) for p in f]
                   for f in jr.assemble(jo)]
    lazy = trec.to_host(_port_recognizer(det_hw).step_raw(frames))
    np.testing.assert_array_equal(lazy["plate_valid"], to["plate_valid"])
    np.testing.assert_allclose(lazy["plate_boxes"], to["plate_boxes"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(lazy["plate_scores"], to["plate_scores"],
                               rtol=0, atol=1e-3)
    for grp in ("chars_orig", "chars_sr"):
        np.testing.assert_array_equal(lazy[grp]["count"], to[grp]["count"])
        np.testing.assert_allclose(lazy[grp]["boxes"], to[grp]["boxes"],
                                   rtol=0, atol=1e-3)


def test_detect_decode_matches_jax(yolov5n_random):
    """Detect(decode=True) on a random yolov5n at (2, 96, 128), float32:
    the decoded pred against JAX's within 1e-3 px (boxes up to ~130 px),
    the raws those of decode=False; and nms_batched on the pred against
    nms_from_raw on the raws, the lazy-decode equivalence of
    tests/test_yolo.py:163-195 (counts equal, the kept boxes within 1e-4
    as sets: random weights give candidates of tied scores, which the two
    selections may order differently)."""
    jm, jp, tm = yolov5n_random
    x = np.random.RandomState(5).rand(2, 96, 128, 3).astype(np.float32)
    jpred, _ = jax.jit(lambda p, v: jm.apply(p, v))(jp, jnp.asarray(x))
    with torch.inference_mode():
        pred, raws = tm(torch.from_numpy(x), decode=True)
        raws_only = tm(torch.from_numpy(x))
    assert pred.shape == jpred.shape == (2, 3 * (12 * 16 + 6 * 8 + 3 * 4), 16)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=0,
                               atol=1e-3)
    for a, b in zip(raws, raws_only):
        assert torch.equal(a, b)
    kw = dict(conf_thres=0.1, iou_thres=0.45, max_det=32, pre_topk=64,
              multi_label=True, agnostic=True, class_ids=(7, 8))
    eager = nms_batched(pred, **kw)
    lazy = nms_from_raw(raws, tm.strides, tm.anchors, **kw)
    assert int(eager["count"].sum()) > 0
    np.testing.assert_array_equal(eager["count"], lazy["count"])
    for b in range(2):
        rows = [torch.cat([d["boxes"][b], d["classes"][b, :, None]], 1)
                [d["valid"][b]].numpy() for d in (eager, lazy)]
        rows = [r[np.lexsort(np.round(r, 2).T[::-1])] for r in rows]
        np.testing.assert_allclose(rows[0], rows[1], rtol=0, atol=1e-4)


def test_new_options_run_as_a_graph_would(monkeypatch):
    """Both options together at (64, 128) on the CPU: a second step builds
    no tensor from host data (what a CUDA graph capture needs: the decode
    grid and anchors, the int8 scales and packs are built once), and the
    step run stage by stage (step_raw(run=...), the profiler's hook) visits
    every stage and gives step_raw's outputs."""
    from lpr_tpu_torch.tools import profile_stages

    rec = profile_stages.build_recognizer("cpu", torch.float32, (64, 128),
                                          int8_detector=True,
                                          lazy_decode=False)
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 60, 120, 3), dtype=np.uint8))
    ref = trec.to_host(rec.step_raw(frames))

    def refuse(*args, **kwargs):
        raise AssertionError("a host table was built inside the step")

    for name in ("from_numpy", "tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, refuse)
    out = trec.to_host(rec.step_raw(frames))
    monkeypatch.undo()
    seen = []

    def run(name, fn, *args):
        seen.append(name)
        return fn(*args)

    staged = trec.to_host(rec.step_raw(frames, run=run))
    assert seen == list(trec.STEP_STAGES)
    for o in (out, staged):
        for k in ("plate_boxes", "plate_scores", "plate_valid", "sr"):
            np.testing.assert_array_equal(o[k], ref[k])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_kernels_match_plain_versions_on_card(case, dtype):
    """I1's codes and sx, I2's int32 sums and its dequantized output equal
    to the plain versions bit for bit on the card (the epilogue rounds
    where they round: float(acc) * (sx * w_s), + b, to the dtype)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    B, H, W, cin, cout, k, s = case
    rng = np.random.RandomState(cin + cout + k)
    x = torch.from_numpy(rng.randn(B, H, W, cin).astype(np.float32)
                         ).to("cuda", dt)
    wq, ws = tnn.quantize_conv_weight(
        (rng.randn(k, k, cin, cout) * 0.05).astype(np.float32))
    wq, ws = torch.from_numpy(wq).cuda(), torch.from_numpy(ws).cuda()
    b = torch.from_numpy(rng.randn(cout).astype(np.float32)).cuda()
    pk = ki.int8_pack(wq)
    n1, n2 = ki.quantize_act.launches, ki.conv_int8.launches
    xq, sx = ki.quantize_act(x)
    pxq, psx = ki.quantize_act_plain(x)
    kw = dict(stride=(s, s), padding=(k // 2, k // 2))
    acc = ki.conv_int8(xq, sx, wq, ws, b, packed=pk, raw=True, **kw)
    y = ki.conv_int8(xq, sx, wq, ws, b, packed=pk, out_dtype=dt, **kw)
    torch.cuda.synchronize()
    assert (ki.quantize_act.launches, ki.conv_int8.launches) == (n1 + 1,
                                                                n2 + 2)
    assert torch.equal(xq, pxq) and torch.equal(sx, psx)
    assert torch.equal(acc, ki.conv_int8_plain(pxq, psx, wq, ws, b, raw=True,
                                               **kw))
    assert torch.equal(y, ki.conv_int8_plain(pxq, psx, wq, ws, b,
                                             out_dtype=dt, **kw))
    with pytest.raises(ValueError, match="groups"):
        ki.conv_int8(xq, sx, wq, ws, b, packed=pk, groups=2, **kw)


def test_int8_bottleneck_csp_runs_where_the_jax_apply_raises():
    """quantize_yolo quantizes BottleneckCSP's bias-free cv2/cv3 (4-D
    weights, K >= 64) in both packages, but the JAX layer calls
    tnn.conv2d on p["cv3"]["w"] directly, which quantize_yolo removed: its
    int8 apply raises KeyError.  The port runs them through conv2d_int8
    (a deliberate difference, ROADMAP section 3); the same set of
    quantized convs, and the int8 output within the int8 path's noise of
    the float one (3 % of the largest logit)."""
    spec = jyolo.YoloSpec(
        nc=3, depth_multiple=1.0, width_multiple=1.0,
        anchors=[[10, 13, 16, 30, 33, 23]],
        backbone=((-1, 1, "Conv", [64, 3, 2]),
                  (-1, 1, "BottleneckCSP", [128])),
        head=(([1], 1, "Detect", ["nc", "anchors"]),))
    jm = jyolo.build_yolo(spec, strides=(2,))
    jp = rand_params(jm)
    jq = jyolo.quantize_yolo(jm, jp)
    x = np.random.RandomState(3).rand(1, 16, 16, 3).astype(np.float32)
    with pytest.raises(KeyError):
        jm.apply(jq, jnp.asarray(x), decode=False)
    tm = tyolo.build_yolo(spec, strides=(2,)).load_state(params_from_jax(jp))
    with torch.inference_mode():
        ref = tm(torch.from_numpy(x))[0]
        tyolo.quantize_yolo(tm)
        got = tm(torch.from_numpy(x))[0]
    assert sorted(tyolo.quantized_convs(tm)) == sorted(_jax_quantized(jq))
    assert {"1/cv2", "1/cv3"} <= set(tyolo.quantized_convs(tm))
    assert (got - ref).abs().max() < 0.03 * ref.abs().max()
