"""G1, the plate crops as one kernel (``kernels/crop_geometry.py``,
``csrc/crop_geometry.cu``).

On the CPU: the wrapper takes the plain version, which is the composition
the step ran before G1 (tile extraction, interpolation-matrix crops, the
skew estimate) value for value; a replay of G1's index maps and two-tap
arithmetic in torch agrees with that composition in float32; the step's
launch counters list G1.  On a card (``-m cuda``): G1 against the plain
version in float32 at the served shapes (batch 32 and 16, three plate
slots, 720x1280 and 1080x1920 frames) with empty slots, boxes on every
frame edge, long and two-row plates, tilts of +-15 degrees and a box under
affine_resample's guard on d; one launch captured in a CUDA graph and
replayed; the wrapper's refusals; one G1 launch a served step."""

import math

import numpy as np
import pytest
import torch

from lpr_tpu_torch.kernels import crop_geometry as kg
from lpr_tpu_torch.ops import image as im
from lpr_tpu_torch.ops.resample import (MAX_DESKEW_DEG, crop_rotated_fast,
                                        plate_tile)
from lpr_tpu_torch.pipeline import recognizer as trec

SR_HW, OCR_HW = (32, 192), (128, 128)


def _scene(B, hw, seed, P=3):
    """Frames (B, H, W, 3) float32 in [0, 1] (values exact in bf16) and
    boxes (B, P, 4): noise with panels of dark bars tilted by up to 15
    degrees.  Slot 0 holds a long plate, slot 1 a two-row plate; slot 2
    cycles through an empty slot, a box on the top-left corner, one on the
    bottom-right corner, a box under the guard on d and a long plate tilted
    by exactly +-15 degrees."""
    rng = np.random.RandomState(seed)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    frames = 0.35 + 0.1 * rng.rand(B, H, W, 3)
    boxes = np.zeros((B, P, 4), np.float64)

    def panel(b, box, deg):
        x1, y1, x2, y2 = box
        t = math.radians(deg)
        # bars along the direction at angle t: the intensity varies across it
        across = -math.sin(t) * xx + math.cos(t) * yy
        period = max(3.0, (y2 - y1) / 4)
        bars = 0.5 + 0.4 * np.sign(np.sin(2 * math.pi * across / period))
        inside = (xx >= x1) & (xx < x2) & (yy >= y1) & (yy < y2)
        frames[b][inside] = bars[inside][:, None]

    for b in range(B):
        sign = 1 if b % 2 else -1
        bw = rng.uniform(W / 12, W / 6)
        x1, y1 = rng.uniform(0, W - bw), rng.uniform(0, H - bw / 4)
        boxes[b, 0] = (x1, y1, x1 + bw, y1 + bw / 4)
        panel(b, boxes[b, 0], sign * rng.uniform(3, 14))
        bw = rng.uniform(W / 20, W / 10)
        x1, y1 = rng.uniform(0, W - bw), rng.uniform(0, H - bw)
        boxes[b, 1] = (x1, y1, x1 + bw, y1 + bw * 0.8)
        panel(b, boxes[b, 1], -sign * rng.uniform(3, 14))
        if P < 3:
            continue
        kind = b % 5
        if kind == 1:
            boxes[b, 2] = (0, 0, W / 8, H / 10)
        elif kind == 2:
            boxes[b, 2] = (W - W / 7, H - H / 9, W, H)
        elif kind == 3:
            boxes[b, 2] = (-5000, H / 2, 15000, H / 2 + 0.5)
        elif kind == 4:
            bw = W / 8
            boxes[b, 2] = (W / 3, H / 3, W / 3 + bw, H / 3 + bw / 4)
            panel(b, boxes[b, 2], sign * MAX_DESKEW_DEG)
    frames = torch.from_numpy(frames.astype(np.float32))
    return (frames.to(torch.bfloat16).float(),
            torch.from_numpy(boxes.astype(np.float32)))


def _composition(x, boxes, deskew=True, long_aspect=1.5):
    """The step's plate geometry as PlateRecognizer._per_plate composed it
    before G1, written out."""
    B, P = boxes.shape[:2]
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1.0)
    sh, sw = SR_HW
    tile, geom = plate_tile(x, boxes, (64, 256))

    def crop(angle, out_hw, **kw):
        return crop_rotated_fast(x, boxes, angle, out_hw, tile=tile,
                                 tile_geom=geom, **kw)

    zero = torch.zeros((B, P), dtype=torch.float32, device=x.device)
    gray = im.rgb_to_gray(crop(zero, (32, 96)).float())
    aspect = (w / 96.0) / (h / 32.0)
    angle = im.estimate_skew_angle(gray, max_abs_deg=15.0,
                                   pixel_aspect=aspect)
    if not deskew:
        angle = angle * 0.0
    is_long = (w / h) > long_aspect
    full = crop(angle, (sh, sw))
    top = crop(angle, (sh, sw // 2), v_range=(-0.5, 0.0))
    bot = crop(angle, (sh, sw // 2), v_range=(0.0, 0.5))
    two_row = torch.cat([top, bot], dim=-2)
    long_img = torch.where(is_long[..., None, None, None], full, two_row)
    ocr_orig = crop(angle, OCR_HW, square=True, mask_outside=True)
    return long_img, ocr_orig, is_long, angle


# ------------------------------------------------------------------ CPU

def _check(got, x, boxes, **kw):
    """G1 held to the plain version in float32 (``crop_errors``: the flags
    equal, the angle within TOL_ANGLE outside the ill-conditioned band,
    the crops at G1's angle within TOL_ABS + TOL_REL x |plain|)."""
    same, angle, n_band, crops = kg.crop_errors(got, x, boxes, **kw)
    print(f"G1 {got[0].dtype} {tuple(x.shape)}: flags equal {same}, angle "
          f"error / tol {angle} outside the band ({n_band} slots in it), "
          f"crop error / tol {crops}")
    assert same and angle < 1 and crops < 1
    return n_band


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("deskew", [True, False])
def test_cpu_wrapper_is_the_composition(dtype, deskew):
    """On CPU tensors the wrapper returns what the step composed before
    G1, in the frames' dtype, and launches nothing."""
    x, boxes = _scene(2, (60, 120), seed=3)
    x = x.to(dtype)
    before = kg.plate_crops.launches
    got = kg.plate_crops(x, boxes, SR_HW, OCR_HW, deskew=deskew)
    want = _composition(x, boxes, deskew=deskew)
    assert kg.plate_crops.launches == before
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cpu_per_plate_takes_the_wrapper():
    """The step's geometry stage on the CPU: G1's plain version with
    ``fast_geometry``, the gather sampler without it."""
    x, boxes = _scene(2, (60, 120), seed=4)
    rec = trec.PlateRecognizer.__new__(trec.PlateRecognizer)
    rec.cfg = trec.PipelineConfig(dtype=torch.float32)
    got = rec._per_plate(x, boxes)
    want = _composition(x, boxes)[:3]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    rec.cfg = trec.PipelineConfig(dtype=torch.float32, fast_geometry=False)
    long_img, ocr, is_long = rec._per_plate(x, boxes)
    assert long_img.shape == want[0].shape and ocr.shape == want[1].shape
    torch.testing.assert_close(is_long, want[2], rtol=0, atol=0)


def _taps(pos, n, normalise):
    """hat_taps of csrc/crop_geometry.cu: (i0, i1, w0, w1)."""
    pos = pos.clamp(0.0, n - 1.0)
    k = torch.floor(pos)
    i0 = k.long()
    i1 = (i0 + 1).clamp(max=n - 1)
    w0 = (1.0 - (pos - k).abs()).clamp(0.0, 1.0)
    w1 = torch.where(i0 + 1 < n,
                     (1.0 - (pos - (k + 1.0)).abs()).clamp(0.0, 1.0),
                     torch.zeros_like(pos))
    if normalise:
        s = (w0 + w1).clamp(min=1e-8)
        w0, w1 = w0 / s, w1 / s
    return i0, i1, w0, w1


def _g1_replay(x, boxes, deskew=True, long_aspect=1.5):
    """G1's arithmetic in torch: the tile from two-tap rows and columns,
    every crop pixel as two pass-2 taps over two-tap pass-1 rows at the
    kernel's positions (``crop_params``, ``sample``), the skew estimate
    on the float32 skew crop, only the selected long layout."""
    B, H, W, _ = x.shape
    P = boxes.shape[1]
    th, tw = kg.TILE_HW
    x1, y1, x2, y2 = [v[..., None] for v in boxes.unbind(-1)]
    cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
    bw, bh = (x2 - x1).clamp(min=1.0), (y2 - y1).clamp(min=1.0)
    side = torch.maximum(bw, bh)
    slack = math.tan(math.radians(MAX_DESKEW_DEG))
    ew, eh = 1.05 * side + slack * bh, 1.05 * bh + slack * side
    su, sv = (1.0 / ew) * tw, (1.0 / eh) * th
    ys = cy - eh * 0.5 + (torch.arange(th) + 0.5) * (eh * (1 / th)) - 0.5
    xs = cx - ew * 0.5 + (torch.arange(tw) + 0.5) * (ew * (1 / tw)) - 0.5
    ry, rx = _taps(ys, H, True), _taps(xs, W, True)
    flat = x.reshape(B, 1, H * W, 3)

    def frame_at(yi, xi):          # (B, P, th, tw, 3)
        idx = (yi[..., :, None] * W + xi[..., None, :]).reshape(B, P, -1)
        return torch.gather(flat.expand(B, P, -1, 3), 2,
                            idx[..., None].expand(-1, -1, -1, 3)
                            ).reshape(B, P, th, tw, 3)

    wy0, wy1 = ry[2][..., :, None, None], ry[3][..., :, None, None]
    wx0, wx1 = rx[2][..., None, :, None], rx[3][..., None, :, None]
    left = wy0 * frame_at(ry[0], rx[0]) + wy1 * frame_at(ry[1], rx[0])
    right = wy0 * frame_at(ry[0], rx[1]) + wy1 * frame_at(ry[1], rx[1])
    tile = (wx0 * left + wx1 * right).reshape(B, P, th * tw, 3)

    def params(angle, oh, ow, v0, v1, square):
        ca, sa = torch.cos(angle), torch.sin(angle)
        ws, hs = (side, side) if square else (bw, bh)

        def uv(i, j):
            du = ((j + 0.5) / ow - 0.5) * ws
            dv = (v0 + (i + 0.5) / oh * (v1 - v0)) * hs
            xf = cx + du * ca - dv * sa - 0.5
            yf = cy + du * sa + dv * ca - 0.5
            return ((xf - (cx - 0.5)) * su + (tw - 1) / 2,
                    (yf - (cy - 0.5)) * sv + (th - 1) / 2)

        (uo, vo), (uj, vj), (ui, vi) = uv(0.0, 0.0), uv(0.0, 1.0), uv(1.0, 0.0)
        a, c, b, d = uj - uo, vj - vo, ui - uo, vi - vo
        d = torch.where(d.abs() < 1e-3,
                        torch.sign(d) * 1e-3 + (d == 0).float() * 1e-3, d)
        return a - b * c / d, b / d, uo - b * vo / d, c, d, vo

    def sample(k, oh, ow):         # (B, P, oh, ow, 3)
        a1, bd, t1, c, d, tv = [v[..., None] for v in k]
        i = torch.arange(oh, dtype=torch.float32)[:, None]
        j = torch.arange(ow, dtype=torch.float32)[None, :]
        r0, r1, wv0, wv1 = _taps(c * j + d * i + tv, th, False)

        def row(r):
            k0, k1, w0, w1 = _taps(j * a1 + r.float() * bd + t1, tw, False)

            def at(kk):
                idx = (r * tw + kk).reshape(B, P, -1, 1).expand(-1, -1, -1, 3)
                return torch.gather(tile, 2, idx).reshape(B, P, oh, ow, 3)
            return w0[..., None] * at(k0) + w1[..., None] * at(k1)

        return wv0[..., None] * row(r0) + wv1[..., None] * row(r1)

    zero = torch.zeros(B, P, 1)
    gray = im.rgb_to_gray(sample(params(zero, 32, 96, -0.5, 0.5, False),
                                 32, 96))
    gx, gy = im.sobel_gradients(gray)
    theta = 0.5 * torch.atan2((2.0 * gx * gy).mean(dim=(-2, -1)),
                              (gx * gx - gy * gy).mean(dim=(-2, -1)))
    tilt = theta - math.pi / 2
    tilt = torch.where(tilt <= -math.pi / 2, tilt + math.pi, tilt)
    tilt = torch.where(tilt > math.pi / 2, tilt - math.pi, tilt)
    aspect = ((bw / 96.0) / (bh / 32.0))[..., 0]
    lim = math.radians(MAX_DESKEW_DEG)
    angle = torch.atan(torch.tan(tilt) / aspect).clamp(-lim, lim)
    if not deskew:
        angle = angle * 0.0
    is_long = ((bw / bh) > long_aspect)[..., 0]
    sh, sw = SR_HW
    full = sample(params(angle[..., None], sh, sw, -0.5, 0.5, False), sh, sw)
    top = sample(params(angle[..., None], sh, sw // 2, -0.5, 0.0, False),
                 sh, sw // 2)
    bot = sample(params(angle[..., None], sh, sw // 2, 0.0, 0.5, False),
                 sh, sw // 2)
    long_img = torch.where(is_long[..., None, None, None], full,
                           torch.cat([top, bot], -2))
    oh, ow = OCR_HW
    ocr = sample(params(angle[..., None], oh, ow, -0.5, 0.5, True), oh, ow)
    jj = (torch.arange(ow) + 0.5) / ow - 0.5
    ii = -0.5 + (torch.arange(oh) + 0.5) / oh
    du, dv = jj[None, :] * side[..., None], ii[:, None] * side[..., None]
    inside = ((du.abs() <= bw[..., None] / 2) & (dv >= bh[..., None] * -0.5)
              & (dv <= bh[..., None] * 0.5))
    return long_img, ocr * inside[..., None], is_long, angle


@pytest.mark.parametrize("deskew", [True, False])
def test_two_tap_replay_matches_the_composition(deskew):
    """G1's formulation (two taps a pass, the tile never leaving float32,
    the discarded long layout never computed) agrees in float32 with the
    interpolation-matrix composition: the angles within 1e-4 rad where the
    orientation is not near 0, and the crops, taken at the replay's angle,
    within 1e-4, the summation order's rounding (``crop_errors``)."""
    x, boxes = _scene(5, (90, 160), seed=5)
    got = _g1_replay(x, boxes, deskew)
    assert _check(got, x, boxes, deskew=deskew) <= 5


def test_kernel_counters_list_g1():
    """The step's launch counts include G1's, so a graph replay credits
    it."""
    assert (kg.plate_crops, "launches") in trec._kernel_counters()
    kg.plate_crops.launches += 2
    try:
        assert trec._counts()[-1] == kg.plate_crops.launches
    finally:
        kg.plate_crops.launches -= 2


def test_wrapper_refuses_a_device_it_does_not_run_on():
    x = torch.empty(1, 8, 8, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kg.plate_crops(x, torch.empty(1, 1, 4, device="meta"))


def test_crop_work_counts_each_touched_pixel_once():
    """The bound's bytes: a frame pixel under two plates' tiles counts
    once, the outputs once a slot."""
    boxes = torch.tensor([[[10.0, 10.0, 30.0, 16.0], [10.0, 10.0, 30.0, 16.0],
                           [0.0, 0.0, 0.0, 0.0]]])
    flops, nbytes = kg.crop_work(boxes, (60, 120))
    one = kg.crop_work(boxes[:, :1], (60, 120))[1]
    per_slot_out = 3 * (32 * 192 + 128 * 128) * 2 + 5
    assert flops == 9 * 3 * 3 * (64 * 256 + 32 * 96 + 32 * 192 + 128 * 128)
    # the second slot adds only its own outputs and box; the empty slot
    # reads pixels (0..1, 0..1) at most
    extra = nbytes - one - 2 * (per_slot_out + 16)
    assert 0 < extra <= 4 * 3 * 2


# ------------------------------------------------------------------ card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [32, 16])
@pytest.mark.parametrize("hw", [(720, 1280), (1080, 1920)])
def test_g1_matches_the_plain_version_at_the_served_shapes(B, hw):
    dev = _card()
    x, boxes = _scene(B, hw, seed=B + hw[0])
    x, boxes = x.to(dev), boxes.to(dev)
    before = kg.plate_crops.launches
    for dt in (torch.float32, torch.bfloat16):
        got = kg.plate_crops(x.to(dt), boxes, SR_HW, OCR_HW)
        torch.cuda.synchronize(dev)
        assert got[0].dtype == got[1].dtype == dt
        assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
        assert _check(got, x, boxes, sr_hw=SR_HW, ocr_hw=OCR_HW) < B
    assert kg.plate_crops.launches == before + 2
    # the long and two-row layouts both ran; slot 2 held every kind
    assert bool(got[2][:, 0].all()) and not bool(got[2][:, 1].any())


@pytest.mark.cuda
def test_g1_deskew_off_and_another_long_aspect():
    dev = _card()
    x, boxes = _scene(8, (720, 1280), seed=11)
    x, boxes = x.to(dev), boxes.to(dev)
    for deskew, aspect in ((False, 1.5), (True, 3.0)):
        kw = dict(long_aspect=aspect, deskew=deskew)
        got = kg.plate_crops(x.to(torch.bfloat16), boxes, SR_HW, OCR_HW,
                             **kw)
        _check(got, x, boxes, sr_hw=SR_HW, ocr_hw=OCR_HW, **kw)
        if not deskew:
            assert (got[3] == 0).all()


@pytest.mark.cuda
def test_g1_in_a_cuda_graph():
    """One launch captured and replayed on new inputs copied into the
    graph's buffers gives the eager launch's outputs bit for bit."""
    dev = _card()
    x, boxes = _scene(4, (720, 1280), seed=12)
    x2, boxes2 = _scene(4, (720, 1280), seed=13)
    sx = x.to(dev, torch.bfloat16)
    sb = boxes.to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kg.plate_crops(sx, sb)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kg.plate_crops(sx, sb)
    sx.copy_(x2.to(dev, torch.bfloat16))
    sb.copy_(boxes2.to(dev))
    graph.replay()
    want = kg.plate_crops(x2.to(dev, torch.bfloat16), boxes2.to(dev))
    torch.cuda.synchronize(dev)
    for g, w in zip(out, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_g1_refuses_what_it_does_not_take():
    dev = _card()
    x = torch.rand(2, 64, 128, 3, device=dev)
    boxes = torch.tensor([[[4.0, 4.0, 40.0, 20.0]]], device=dev).expand(
        2, 1, 4).contiguous()
    before = kg.plate_crops.launches
    for bad in (dict(x=x.half()), dict(x=x[:, :, ::2]),
                dict(boxes=boxes.double()), dict(boxes=boxes.cpu()),
                dict(tile_hw=(32, 128)), dict(sr_hw=(32, 191)),
                dict(boxes=boxes[:1])):
        kw = dict(x=x, boxes=boxes)
        kw.update(bad)
        with pytest.raises(ValueError):
            kg.plate_crops(**kw)
    assert kg.plate_crops.launches == before


@pytest.mark.cuda
def test_served_step_launches_g1_once():
    """The frozen step's graph holds one G1 launch, credited at each
    replay."""
    from lpr_tpu_torch.models import lpsr as tlpsr
    from lpr_tpu_torch.models import yolo as tyolo
    from lpr_tpu_torch.tools.synth import synth_frames

    dev = _card()
    char, _, _ = tyolo.load_char_ocr_npz("checkpoints/char_ocr_synth.npz",
                                         device=dev)
    rec = trec.PlateRecognizer(
        tyolo.load_plate_detector("checkpoints/plate_det640.npz",
                                  device=dev),
        char,
        tlpsr.load_lpsr("checkpoints/lpsr_synth_glare/best_model.npz",
                        device=dev),
        trec.PipelineConfig(det_hw=(736, 1280), dtype=torch.bfloat16),
        device=dev)
    frames = synth_frames(2, (720, 1280), 7)
    rec.step_raw(frames)
    held = dict(zip(trec._kernel_counters(),
                    next(iter(rec._graphs.values())).launches))
    assert held[(kg.plate_crops, "launches")] == 1
    before = kg.plate_crops.launches
    for _ in range(3):
        rec.step_raw(frames)
    torch.cuda.synchronize(dev)
    assert kg.plate_crops.launches == before + 3
