"""The port's profiling tools (lpr_tpu_torch/tools), on the CPU at small
sizes: prefix_forward against the JAX tool's prefix_apply, the stage split
of profile_stages against step_raw, and every tool's main."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu_torch.kernels.yolo_front import front_pack
from lpr_tpu_torch.kernels.yolo_mid import mid_pack
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch import bench
from lpr_tpu_torch.pipeline.recognizer import STEP_STAGES, to_host
from lpr_tpu_torch.tools import (bench_convs, bench_pack, bench_serving,
                                 bench_sr_convs, prof_pipeline,
                                 probe_front_stages, profile_detector_layers,
                                 profile_stages)
from lpr_tpu_torch.tools.profile_detector_layers import prefix_forward

from . import torch_ref
from .torch_ref import PLATE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETECT = 24          # the plate detector's Detect layer


@pytest.fixture(scope="module")
def jax_prefix_apply(tmp_path_factory):
    """tools/profile_detector_layers.py's prefix_apply; the module's
    setdefault of JAX_COMPILATION_CACHE_DIR and its sys.path insert are
    undone after the import."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR",
                  str(tmp_path_factory.mktemp("jax_cache")))
        mp.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location(
            "_jax_profile_detector_layers",
            os.path.join(ROOT, "tools", "profile_detector_layers.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod.prefix_apply


@pytest.fixture(scope="module")
def plate():
    return tyolo.load_plate_detector(PLATE, device="cpu")


def _x(seed=0, hw=(64, 128)):
    return np.random.RandomState(seed).rand(1, *hw, 3).astype(np.float32)


@pytest.mark.parametrize("upto", [2, 4, 9, 17])
def test_prefix_forward_matches_jax_prefix_apply(jax_prefix_apply, plate,
                                                 upto):
    """Layers [0, upto] of the real plate detector, float32, no kernels:
    the port's prefix against the JAX tool's."""
    model, params = torch_ref.plate()
    x = _x()
    ref = np.asarray(jax.jit(lambda p, v: jax_prefix_apply(
        model, p, v, upto))(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = prefix_forward(plate, torch.from_numpy(x), upto).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_prefix_forward_at_detect_is_the_forward(plate):
    x = torch.from_numpy(_x(1))
    front, mid = front_pack(plate), mid_pack(plate)
    with torch.inference_mode():
        ref = plate(x)
        for kw in ({}, {"front": front}, {"front": front, "mid": mid}):
            got = prefix_forward(plate, x, DETECT, **kw)
            assert len(got) == len(ref) == 3
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                           atol=1e-4)
        # below the fused layers the prefix is the kernel's own output
        assert torch.equal(prefix_forward(plate, x, 2, front, mid),
                           prefix_forward(plate, x, 2, front))
        with pytest.raises(ValueError):
            prefix_forward(plate, x, 4, mid=mid)


@pytest.fixture(scope="module")
def rec():
    return profile_stages.build_recognizer("cpu", torch.float32, (64, 128))


def _frames():
    return np.random.RandomState(4).randint(0, 256, (1, 60, 120, 3),
                                            dtype=np.uint8)


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_stage_methods_chained_reproduce_step_raw(rec):
    """The recognizer's stage methods, chained by hand in step order on one
    frame, give step_raw's outputs; so does stage_split, whose stages are
    STEP_STAGES in order and rerun to the same results."""
    frames = _frames()
    ref = to_host(rec.step_raw(frames))
    with torch.inference_mode():
        x = rec._upload(frames)
        x, lb, gain, pad = rec._letterbox(x)
        det = rec._plate_nms(rec._detect(lb))
        boxes, scores, classes, areas = rec._top_plates(det, gain, pad, 60,
                                                        120)
        long_img, ocr_orig, is_long = rec._per_plate(x, boxes)
        sr = rec._enhance(long_img)
        cdet = rec._char_nms(rec.char_model(
            rec._ocr_input(sr, ocr_orig, is_long)))
    np.testing.assert_array_equal(boxes.numpy(), ref["plate_boxes"])
    np.testing.assert_array_equal((areas > 0).numpy(), ref["plate_valid"])
    np.testing.assert_array_equal(sr.reshape(ref["sr"].shape).numpy(),
                                  ref["sr"])
    np.testing.assert_array_equal(
        cdet["classes"][3:].reshape(1, 3, -1).numpy(),
        ref["chars_sr"]["classes"])

    out, stages = profile_stages.stage_split(rec, frames)
    _assert_same(to_host(out), ref)
    assert tuple(n for n, _ in stages) == STEP_STAGES
    with torch.inference_mode():
        lpsr = dict(stages)["LPSR"]()
    np.testing.assert_array_equal(lpsr.reshape(ref["sr"].shape).numpy(),
                                  ref["sr"])


def test_profile_stages_rows_on_cpu(rec):
    step, rows, alt = profile_stages.split_rows(rec, _frames(), 1, 2)
    assert [r.name for r in rows] == list(STEP_STAGES)
    assert all(len(r.host) == 2 and r.host_ms > 0 for r in rows)
    assert all(r.busy_ms is None and r.launches is None for r in rows)
    assert [r.name for r in alt] == ["plate detector, plain layers",
                                     "plate detector, K1 + K3",
                                     "LPSR, lpsr_plain"]
    lines = profile_stages.report(step, rows, alt)
    assert lines[-6].startswith("sum of stages")
    assert lines[-5].startswith("unaccounted")
    assert "not measured" in lines[1]


TINY = {
    "probe_front_stages": ["--batch", "1", "--frame-hw", "60", "120",
                           "--det-hw", "64", "128", "--iters", "1",
                           "--rounds", "1"],
    "profile_stages": ["--batch", "1", "--frame-hw", "60", "120",
                       "--det-hw", "64", "128", "--dtype", "float32",
                       "--calls", "1", "--rounds", "1"],
    "profile_detector_layers": ["--batch", "1", "--det-hw", "64", "128",
                                "--dtype", "float32", "--calls", "1",
                                "--rounds", "1"],
    "prof_pipeline": [],
    "bench_convs": ["--batch", "1", "--iters", "1", "--rounds", "1",
                    "--div", "8"],
    "bench_sr_convs": ["--n", "1", "--iters", "1", "--rounds", "1",
                       "--div", "4"],
    "bench": ["--frame-hw", "60", "120", "--det-w", "128"],
    "bench_pack": ["--batch", "1", "--iters", "1", "--rounds", "1",
                   "--frame-hw", "60", "120", "--det-hw", "64", "128"],
    "bench_serving": ["--clients", "2", "--frames", "1", "--max-batch", "2",
                      "--frame-hw", "60", "120", "--det-w", "128",
                      "--dtype", "f32", "--pool"],
}
EXPECT = {
    "probe_front_stages": ["front[dma ]", "front[stem]", "front[down]",
                           "front[full]"],
    "profile_stages": list(STEP_STAGES) + ["sum of stages", "unaccounted"],
    "profile_detector_layers": ["[0.. 2] C3", "[0..24] Detect"],
    "prof_pipeline": ["stage=det_nms det=64 B=1"],
    "bench_convs": ["stem S2D 12->32", "char C3 32->32 k3", "skipped"],
    "bench_sr_convs": ["LPSR.forward (1 crops, 8x48, composed)",
                       "char OCR forward (2 canvases, 32^2)",
                       "dense 3x3  80->16 @8x48", "lff   1x1  96->32",
                       "one RDB (4 dense + lff, composed)"],
    "bench": ['"metric": "e2e_detect_sr_ocr_frames_per_sec_per_chip"',
              '"value": null', '"flops_per_frame": ', '"mfu_pct": null',
              '"packed_input": true', '"det_hw": [64, 128]'],
    "bench_pack": ["host letterbox (ms per frame)",
                   "upload, pinned (uint8 letterbox)", "K1 uint8",
                   "letterbox+norm + K1 bf16"],
    "bench_serving": ['"metric": "serving_frames_per_sec"', '"mode": "pool"',
                      '"requests": 2', '"value": null',
                      '"latency_ms_p99": null', '"cpu_latency_ms_p99": ',
                      '"packed_input": true', '"det_hw": [64, 128]'],
}


@pytest.mark.parametrize("tool", sorted(TINY))
def test_tool_main_runs_on_cpu(tool, monkeypatch, capsys):
    mod = {"probe_front_stages": probe_front_stages,
           "profile_stages": profile_stages,
           "profile_detector_layers": profile_detector_layers,
           "prof_pipeline": prof_pipeline, "bench_convs": bench_convs,
           "bench_sr_convs": bench_sr_convs, "bench": bench,
           "bench_pack": bench_pack, "bench_serving": bench_serving}[tool]
    for k, v in {"PROF_DET_HW": "64", "PROF_BATCH": "1", "PROF_STEPS": "1",
                 "PROF_STAGE": "det_nms", "BENCH_BATCH": "1",
                 "BENCH_STEPS": "2", "BENCH_REPS": "1"}.items():
        monkeypatch.setenv(k, v)
    assert mod.main(TINY[tool] + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("card: CPU")
    for text in EXPECT[tool]:
        assert text in out, (text, out)
