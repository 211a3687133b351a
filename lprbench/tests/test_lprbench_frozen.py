"""The benchmark's frozen copies equal the port's functions today at the
cells' shapes: the frame generator, the kernels' work arithmetic, the
peaks, and the model-FLOP count of each configuration (the detector's and
char OCR's convolutions and products, as FlopCounterMode counts the port's
plain forward, and LPSR's as ``lpsr_work`` counts it)."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from lprbench.frames import synth_frames
from lprbench.tests.conftest import ROOT, config, manifest
from lprbench.work import k1_front, k2_lpsr
from lprbench.work.model_flops import per_frame

CONFIGS = [c["name"] for c in manifest()["configs"]]


def test_frames_equal_the_ports_synth_frames():
    from lpr_tpu_torch.tools.synth import synth_frames as port

    for hw, seed in (((720, 1280), 5), ((1080, 1920), 2**31 + 7)):
        np.testing.assert_array_equal(synth_frames(2, hw, seed % 2**32),
                                      port(2, hw, seed % 2**32))


@pytest.mark.parametrize("name", CONFIGS)
def test_kernel_work_equals_the_ports(name):
    from lpr_tpu_torch.kernels.lpsr import lpsr_work
    from lpr_tpu_torch.kernels.yolo_front import front_work

    cfg = config(name)
    for traffic in ("closed64", "cams32"):
        mix = json.loads((ROOT / "lprbench" / "traffic" / f"{traffic}.json")
                         .read_text())
        b = mix["server"]["max_batch"]
        h, w = cfg["pipeline"]["det_hw"]
        assert k1_front.cell_work(cfg, mix) == front_work(b, h, w)
        sh, sw = cfg["pipeline"]["sr_hw"]
        assert k2_lpsr.cell_work(cfg, mix) == lpsr_work(
            b * cfg["pipeline"]["max_plates"], sh, sw)


def test_peaks_equal_the_ports():
    from lpr_tpu_torch.tools import _timing

    peaks = json.loads((ROOT / "lprbench" / "peaks.json").read_text())
    assert peaks["bf16_flops"] == _timing.PEAK_BF16_FLOPS
    assert peaks["hbm_bytes_s"] == _timing.PEAK_BYTES_S


@pytest.mark.parametrize("name", CONFIGS)
def test_model_flops_equal_the_ports_forward(name):
    from lpr_tpu_torch.kernels.lpsr import lpsr_work
    from lpr_tpu_torch.models.yolo import (load_char_ocr_npz,
                                           load_plate_detector)

    cfg = config(name)
    p = cfg["pipeline"]
    counts = per_frame(cfg)
    det = load_plate_detector(cfg["checkpoints"]["plate_detector"], "cpu")
    char, _, _ = load_char_ocr_npz(cfg["checkpoints"]["char_ocr"], "cpu")
    with torch.device("meta"):
        det, char = det.to("meta"), char.to("meta")
    with FlopCounterMode(display=False) as fc:
        det.forward_from(torch.empty((1, *p["det_hw"], 3), device="meta"),
                         0)
    assert counts["detector"] == fc.get_total_flops()
    P = p["max_plates"]
    with FlopCounterMode(display=False) as fc:
        char.forward_from(torch.empty((2 * P, *p["ocr_hw"], 3),
                                      device="meta"), 0)
    assert counts["char_ocr"] == fc.get_total_flops()
    assert counts["lpsr"] == lpsr_work(P, *p["sr_hw"])[0]
