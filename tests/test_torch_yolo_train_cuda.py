"""The detector trainers on the card's machine (no JAX and no OpenCV in
this file): the host library's three image operations against their plain
numpy versions (that machine has no cv2 to compare with; byte for byte),
one augmented sample through each, and one YoloTrainer step on the card
against the same step on the CPU (TF32 off).  Marked ``cuda``; each
decides in its body whether a card is present and skips without one.  Run
on the card with ``python -m pytest -q -m cuda
tests/test_torch_yolo_train_cuda.py``."""

import math
import random
import types

import numpy as np
import pytest
import torch

from lpr_tpu_torch import native
from lpr_tpu_torch.data import cv_plain
from lpr_tpu_torch.data import yolo_data
from lpr_tpu_torch.models.yolo import yolov5
from lpr_tpu_torch.train.yolo import (YoloTrainConfig, YoloTrainer,
                                      _is_bias, _is_running_stat)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_host_augment_equals_its_plain_versions():
    _need_card()
    rng = np.random.RandomState(0)
    for h, w, oh, ow in ((720, 1280, 360, 640), (720, 1280, 640, 1138),
                         (37, 53, 20, 31), (50, 60, 100, 120)):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        np.testing.assert_array_equal(native.cv_resize_linear(img, ow, oh),
                                      cv_plain.resize_linear(img, ow, oh))
        a = math.radians(rng.uniform(-10, 10))
        m = np.array([[math.cos(a), -math.sin(a), rng.uniform(-30, 30)],
                      [math.sin(a), math.cos(a), rng.uniform(-30, 30)]])
        np.testing.assert_array_equal(
            native.cv_warp_affine(img, m, (ow, oh)),
            cv_plain.warp_affine(img, m, (ow, oh)))
        luts = [rng.randint(0, 256, 256).astype(np.uint8) for _ in range(3)]
        luts[0] %= 180
        np.testing.assert_array_equal(native.cv_hsv_lut(img, *luts),
                                      cv_plain.hsv_lut(img, *luts))


@pytest.mark.cuda
def test_augmented_sample_equals_plain_route(tmp_path):
    _need_card()
    from lpr_tpu_torch.tools.synth import write_yolo_tree

    img_dir, lbl_dir = write_yolo_tree(str(tmp_path), 4)
    ds = yolo_data.YoloDataset(img_dir, lbl_dir, (320, 320),
                               aug=yolo_data.YoloAugConfig(degrees=5,
                                                           copy_paste=0.5))
    host = ds.get(1, rng=random.Random(2))
    plain = types.SimpleNamespace(cv_resize_linear=cv_plain.resize_linear,
                                  cv_warp_affine=cv_plain.warp_affine,
                                  cv_hsv_lut=cv_plain.hsv_lut)
    saved, yolo_data.native = yolo_data.native, plain
    try:
        ref = ds.get(1, rng=random.Random(2))
    finally:
        yolo_data.native = saved
    np.testing.assert_array_equal(host[0], ref[0])
    np.testing.assert_array_equal(host[1], ref[1])


@pytest.mark.cuda
def test_det_step_on_card_matches_cpu(monkeypatch):
    """yolov5s nc=11 at 320x320, batch 2, past warm-up: the loss within
    1e-5 relative; the trainer's gradients (``YoloTrainer.grads``) against
    the float64 ones of the same batch on the CPU, in norm tensor by
    tensor over those above 1e-4 of the largest, the card's worst relative
    error within 4 times the CPU float32's worst (batch statistics amplify
    float32 rounding on both sides alike); each weight within 1e-6 plus
    lr * (1 + momentum) times the two sides' momentum difference; the
    running statistics within 1e-5 of each tensor's largest."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from lpr_tpu_torch.models.yolo_train import train_forward
    from lpr_tpu_torch.tools.bench_train_step import det_batch
    from lpr_tpu_torch.train.yolo_loss import yolo_loss

    x, lab = det_batch(2, hw=(320, 320))
    sides = {d: YoloTrainer(yolov5("s", nc=11), YoloTrainConfig(),
                            steps_per_epoch=100, device=d)
             for d in ("cuda", "cpu")}
    w0 = sides["cpu"].init(torch.Generator().manual_seed(0))["params"]
    out = {}
    for d, tr in sides.items():
        st = tr.init(params={k: v.detach() for k, v in w0.items()})
        st["step"] = 1000
        st, total, _ = tr.step(st, x, lab)
        out[d] = (st, float(total))
    (card, l_card), (cpu, l_cpu) = out["cuda"], out["cpu"]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)

    p64 = {k: v.detach().double().requires_grad_(not _is_running_stat(k))
           for k, v in w0.items()}
    raws, _ = train_forward(sides["cpu"].model, p64,
                            torch.from_numpy(x).double())
    t64, _ = yolo_loss(raws, torch.from_numpy(lab).double(),
                       sides["cpu"].anchors.double())
    keys = [k for k, v in p64.items() if v.requires_grad]
    g64 = {k: torch.zeros_like(p64[k]) if g is None else g
           for k, g in zip(keys, torch.autograd.grad(
               t64, [p64[k] for k in keys], allow_unused=True))}
    top = max(float(g.norm()) for g in g64.values())
    worst = {}
    for d, tr in sides.items():
        g, _, _, _ = tr.grads(tr.init(params={k: v.detach()
                                              for k, v in w0.items()}
                                      )["params"], torch.from_numpy(x).to(d),
                              torch.from_numpy(lab).to(d))
        assert set(g) == set(g64)
        worst[d] = max(float((g[k].cpu().double() - r).norm() / r.norm())
                       for k, r in g64.items()
                       if float(r.norm()) > 1e-4 * top)
    assert worst["cuda"] <= 4 * max(worst["cpu"], 1e-7), worst

    lr_w, lr_b, mom = sides["cpu"].rates(1000)
    for k, p in cpu["params"].items():
        got = card["params"][k].detach().cpu()
        if _is_running_stat(k):
            assert (got - p).abs().max() <= 1e-5 * p.abs().max(), k
            continue
        dm = (card["momenta"][k].cpu() - cpu["momenta"][k]).abs()
        bound = 1e-6 + (lr_b if _is_bias(k) else lr_w) * (1 + mom) * dm
        assert bool(((got - p.detach()).abs() <= bound).all()), k
