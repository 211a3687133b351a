"""The port stands alone: it imports neither jax, nor lpr_tpu, nor PIL, and
its entry points refuse to run without a card unless asked for the CPU."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["PIL"] = None
import lpr_tpu_torch
for m in pkgutil.walk_packages(lpr_tpu_torch.__path__, "lpr_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n, m in sys.modules.items() if m is not None and (
    n == "lpr_tpu" or n.startswith(("lpr_tpu.", "jax", "PIL"))))
print("BAD", bad)
"""


def _run(args, cwd, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          env={**os.environ, **env}, capture_output=True,
                          text=True, timeout=300)


def test_port_and_chip_smoke_import_no_jax_lpr_tpu_or_pil():
    r = _run(["-c", _PROBE], ROOT, PYTHONPATH=ROOT)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_entry_points_raise_without_a_card(monkeypatch):
    from lpr_tpu_torch import resolve_device
    from lpr_tpu_torch.models import lpsr, yolo
    from lpr_tpu_torch.pipeline.recognizer import PlateRecognizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        yolo.load_plate_detector("checkpoints/plate_det640.npz")
    with pytest.raises(RuntimeError, match="CUDA"):
        lpsr.load_lpsr("checkpoints/lpsr_synth_glare/best_model.npz")
    char, _ = yolo.load_char_ocr_npz("checkpoints/char_ocr_synth.npz",
                                     device="cpu")
    plate = yolo.load_plate_detector("checkpoints/plate_det640.npz",
                                     device="cpu")
    sr = lpsr.load_lpsr("checkpoints/lpsr_synth_glare/best_model.npz",
                        device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PlateRecognizer(plate, char, sr)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_without_the_repo(alone,
                                                             tmp_path):
    """No card (CUDA hidden), or a directory holding chip_smoke.py and
    nothing else: non-zero exit and no result line."""
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        r = _run(["chip_smoke.py"], tmp_path, PYTHONPATH="")
    else:
        r = _run(["chip_smoke.py"], ROOT, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
