"""The whole slice — the port's PlateRecognizer against the JAX one — on the
CPU, in float32, with the repo's real checkpoints.

Frames are synthetic street scenes with rendered plates
(tools/synth_plates.py), made from fixed seeds.  The JAX step is one XLA
program whose fusions round the crop coordinates differently from eager
ops; on the sharp edges of rendered plates that moves crop and SR pixels by
up to ~3e-3 (measured), so SR crops are held to 1e-2.  Plate boxes are held
to 0.5 px, validity, classes and strings exactly.
"""

import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.models import lpsr as jlpsr
from lpr_tpu.pipeline import recognizer as jrec
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.pipeline import recognizer as trec

from . import torch_ref
from .torch_ref import CHAR, LPSR, PLATE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synth_frames(n, hw, seed):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from synth_plates import random_plate_text, render_frame_with_plates

    rng = random.Random(seed)
    h, w = hw
    out = []
    for b in range(n):
        plates = []
        for _ in range(2):
            two = b % 2 == 1
            pw = rng.randint(90, 140)
            ph = int(pw * (0.7 if two else 0.3))
            x1, y1 = rng.randint(0, w - pw - 1), rng.randint(0, h - ph - 1)
            plates.append((random_plate_text(rng, two), two,
                           (x1, y1, x1 + pw, y1 + ph)))
        out.append(render_frame_with_plates(hw, plates,
                                            np.random.RandomState(b)))
    return np.stack(out)


def build_pair(det_hw, **cfg_kw):
    plate, pp = torch_ref.plate()
    char, cp, names = torch_ref.char()
    jr = jrec.PlateRecognizer(
        plate, pp, char, cp, torch_ref.lpsr(), jlpsr.LPSRConfig(),
        jrec.PipelineConfig(det_hw=det_hw, dtype=jnp.float32, **cfg_kw),
        char_names=names)
    tchar, _, ck = tyolo.load_char_ocr_npz(CHAR, device="cpu")
    names = ck.names
    tr = trec.PlateRecognizer(
        tyolo.load_plate_detector(PLATE, device="cpu"), tchar,
        tlpsr.load_lpsr(LPSR, device="cpu"),
        trec.PipelineConfig(det_hw=det_hw, dtype=torch.float32, **cfg_kw),
        char_names=names, device="cpu")
    return jr, tr


def compare(jr, tr, frames):
    jo = jax.device_get(jr.step_raw(jnp.asarray(frames)))
    to = trec.to_host(tr.step_raw(frames))
    valid = jo["plate_valid"]
    np.testing.assert_array_equal(to["plate_valid"], valid)
    assert valid.any(), "the frames must hold detectable plates"
    np.testing.assert_array_equal(to["is_long"][valid], jo["is_long"][valid])
    np.testing.assert_array_equal(to["plate_classes"], jo["plate_classes"])
    np.testing.assert_allclose(to["plate_boxes"][valid],
                               jo["plate_boxes"][valid], rtol=0, atol=0.5)
    np.testing.assert_allclose(to["sr"][valid], jo["sr"][valid], rtol=0,
                               atol=1e-2)
    # every slot of the port is finite (see ROADMAP "Faults found")
    for k in ("plate_boxes", "plate_scores", "sr"):
        assert np.isfinite(to[k]).all(), k
    ja, ta = jr.assemble(jo), tr.assemble(to)
    assert [[(p["text"], p["text_sr"], p["class_id"]) for p in f]
            for f in ta] == [[(p["text"], p["text_sr"], p["class_id"])
                              for p in f] for f in ja]
    return ta


@pytest.mark.parametrize("cfg_kw", [
    {}, dict(fast_geometry=False, ocr_on_original=False, deskew=False),
    dict(fused_mid=True)])
def test_slice_matches_jax_recognizer(cfg_kw):
    """Two 180x320 frames, detector at 192x320; the default configuration,
    the gather sampler / SR-only OCR / no deskew one, and fused_mid (on the
    CPU the JAX side runs the unfused layers and the port the plain
    versions of K1 and K3, so the results must be the same)."""
    jr, tr = build_pair((192, 320), **cfg_kw)
    assert (tr._mid is not None) == cfg_kw.get("fused_mid", False)
    results = compare(jr, tr, synth_frames(2, (180, 320), seed=3))
    assert sum(len(f) for f in results) >= 2
    assert any(p["text_sr"] for f in results for p in f)
    assert (any(p["text"] for f in results for p in f)
            == cfg_kw.get("ocr_on_original", True))


@pytest.mark.slow
def test_slice_matches_jax_recognizer_on_demo_frame():
    """The real demo frame (880x495) at the production detector geometry
    736x1280."""
    from PIL import Image

    frame = np.asarray(Image.open(os.path.join(
        ROOT, "tests", "fixtures", "real_frames", "demo_frame.png"))
        .convert("RGB"))[None]
    jr, tr = build_pair((736, 1280))
    jo = jax.device_get(jr.step_raw(jnp.asarray(frame)))
    to = trec.to_host(tr.step_raw(frame))
    np.testing.assert_array_equal(to["plate_valid"], jo["plate_valid"])
    v = jo["plate_valid"]
    np.testing.assert_allclose(to["plate_boxes"][v], jo["plate_boxes"][v],
                               rtol=0, atol=0.5)
    assert ([[(p["text"], p["text_sr"]) for p in f]
             for f in tr.assemble(to)]
            == [[(p["text"], p["text_sr"]) for p in f]
                for f in jr.assemble(jo)])


def test_empty_plate_slots_are_finite_in_the_port():
    """Zero-box slots (no plate): the JAX step divides the skew aspect by
    the raw box width and can return NaN crops there; the port clamps the
    width like the height and stays finite."""
    _, tr = build_pair((64, 128))
    x = torch.rand(1, 64, 128, 3)
    long_img, ocr, _ = tr._per_plate(x, torch.zeros(1, 3, 4))
    assert torch.isfinite(long_img).all() and torch.isfinite(ocr).all()


def test_recognizer_rejects_what_the_front_kernel_cannot_take():
    char, _, _ = tyolo.load_char_ocr_npz(CHAR, device="cpu")
    plate = tyolo.load_plate_detector(PLATE, device="cpu")
    lpsr = tlpsr.load_lpsr(LPSR, device="cpu")
    with pytest.raises(ValueError):
        trec.PlateRecognizer(plate, char, lpsr, trec.PipelineConfig(
            det_hw=(200, 320), dtype=torch.float32), device="cpu")
    rec = trec.PlateRecognizer(plate, char, lpsr, trec.PipelineConfig(
        det_hw=(200, 320), dtype=torch.float32, fused_front=False),
        device="cpu")
    assert rec._front is None
    with pytest.raises(ValueError):     # fused_mid needs fused_front
        trec.PlateRecognizer(plate, char, lpsr, trec.PipelineConfig(
            det_hw=(192, 320), dtype=torch.float32, fused_front=False,
            fused_mid=True), device="cpu")


def test_slice_with_a_small_lpsr_configuration_matches_jax():
    """A non-production LPSRConfig (the one __graft_entry__ builds) with
    lpsr_init's random weights carried across by params_from_jax: the port
    does not pack K2 for it, runs LPSR.forward, and matches the JAX
    recognizer as the default configuration does."""
    from lpr_tpu_torch.kernels.lpsr import lpsr_kernel_takes
    from lpr_tpu_torch.weights.checkpoint import params_from_jax

    small = dict(num_features=8, growth_rate=4, num_blocks=2, num_layers=2)
    jcfg, tcfg = jlpsr.LPSRConfig(**small), tlpsr.LPSRConfig(**small)
    params = jax.device_get(jax.jit(lambda k: jlpsr.lpsr_init(k, jcfg))(
        jax.random.PRNGKey(1)))
    det_hw = (192, 320)
    plate, pp = torch_ref.plate()
    char, cp, names = torch_ref.char()
    jr = jrec.PlateRecognizer(
        plate, pp, char, cp, params, jcfg,
        jrec.PipelineConfig(det_hw=det_hw, dtype=jnp.float32),
        char_names=names)
    tchar, _, ck = tyolo.load_char_ocr_npz(CHAR, device="cpu")
    names = ck.names
    tr = trec.PlateRecognizer(
        tyolo.load_plate_detector(PLATE, device="cpu"), tchar,
        tlpsr.LPSR(params_from_jax(params), tcfg),
        trec.PipelineConfig(det_hw=det_hw, dtype=torch.float32),
        char_names=names, device="cpu")
    assert not lpsr_kernel_takes(tcfg) and tr._lpsr is None
    assert lpsr_kernel_takes(tlpsr.LPSRConfig())
    results = compare(jr, tr, synth_frames(2, (180, 320), seed=3))
    assert sum(len(f) for f in results) >= 2
