"""The port stands alone: it imports neither jax, nor ml_dtypes, nor
lpr_tpu, nor PIL, and its entry points refuse to run without a card
unless asked for the CPU."""

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
sys.modules["ml_dtypes"] = None
sys.modules["PIL"] = None
import lpr_tpu_torch
for m in pkgutil.walk_packages(lpr_tpu_torch.__path__, "lpr_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
import tests.pt_fixture
bad = sorted(n for n, m in sys.modules.items() if m is not None and (
    n == "lpr_tpu" or n.startswith(("lpr_tpu.", "jax", "ml_dtypes", "PIL"))))
print("BAD", bad)
"""


def _run(args, cwd, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          env={**os.environ, **env}, capture_output=True,
                          text=True, timeout=300)


def test_port_and_chip_smoke_import_no_jax_lpr_tpu_or_pil():
    """Every module of the port, chip_smoke.py and the .pt writer it
    imports (tests/pt_fixture.py), imported with jax, ml_dtypes and PIL
    unimportable: none of them, nor lpr_tpu, loads."""
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
    char, _, _ = yolo.load_char_ocr_npz("checkpoints/char_ocr_synth.npz",
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


def test_the_walk_covers_the_serving_modules():
    """The import probe above walks every module of the port, the host
    library bindings, the HTTP front end and the serving benchmark
    included."""
    import pkgutil

    import lpr_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(lpr_tpu_torch.__path__,
                                                   "lpr_tpu_torch.")}
    assert {"lpr_tpu_torch.native", "lpr_tpu_torch.serve.http",
            "lpr_tpu_torch.serve.server",
            "lpr_tpu_torch.tools.bench_serving"} <= names


def test_the_walk_covers_the_int8_kernels_and_the_model_zoo():
    """The import probe above also walks the int8 kernels' wrapper, the
    detector wrapper, the CycleGAN, the LPSR variants and the torch -> HWIO
    helpers, so none of them may import jax, lpr_tpu or PIL."""
    import pkgutil

    import lpr_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(lpr_tpu_torch.__path__,
                                                   "lpr_tpu_torch.")}
    assert {"lpr_tpu_torch.kernels.conv_int8",
            "lpr_tpu_torch.models.detector", "lpr_tpu_torch.models.cyclegan",
            "lpr_tpu_torch.models.lpsr_variants",
            "lpr_tpu_torch.weights.convert"} <= names


def test_the_walk_covers_the_eval_and_cli_modules():
    """The import probe above also walks the evaluation modules, the CLIs,
    the image files and the annotation, so none of them may import jax,
    lpr_tpu or PIL."""
    import pkgutil

    import lpr_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(lpr_tpu_torch.__path__,
                                                   "lpr_tpu_torch.")}
    assert {"lpr_tpu_torch.eval.harness", "lpr_tpu_torch.eval.metrics",
            "lpr_tpu_torch.eval.plots", "lpr_tpu_torch.cli.run",
            "lpr_tpu_torch.cli.sr", "lpr_tpu_torch.cli.serve",
            "lpr_tpu_torch.cli.evaluate",
            "lpr_tpu_torch.cli.find_improvement", "lpr_tpu_torch.imageio",
            "lpr_tpu_torch.pipeline.annotate", "lpr_tpu_torch.pipeline.draw",
            "lpr_tpu_torch.weights.torch_ckpt"} <= names


def test_the_walk_covers_the_weights_and_export_modules():
    """The import probe above also walks the pickled-module reader, the
    ONNX emitter, reader and executor, the torch and torch.export
    exporters and the export CLI, so none of them may import jax,
    ml_dtypes, lpr_tpu or PIL."""
    import pkgutil

    import lpr_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(lpr_tpu_torch.__path__,
                                                   "lpr_tpu_torch.")}
    assert {"lpr_tpu_torch.weights.torch_ckpt",
            "lpr_tpu_torch.weights.onnx_export",
            "lpr_tpu_torch.weights.onnx_import",
            "lpr_tpu_torch.weights.onnx_run",
            "lpr_tpu_torch.weights.export_torch",
            "lpr_tpu_torch.weights.export_program",
            "lpr_tpu_torch.cli.export"} <= names


def test_the_walk_covers_the_parallel_config_and_utility_modules():
    """The import probe above also walks the mesh, the process group and
    its collectives, the config files, autobatch and observability, and
    the autobatch tool, so none of them may import jax, lpr_tpu or PIL."""
    import pkgutil

    import lpr_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(lpr_tpu_torch.__path__,
                                                   "lpr_tpu_torch.")}
    assert {"lpr_tpu_torch.config", "lpr_tpu_torch.parallel.mesh",
            "lpr_tpu_torch.parallel.multiproc",
            "lpr_tpu_torch.parallel.collectives",
            "lpr_tpu_torch.utils.autobatch",
            "lpr_tpu_torch.utils.observability",
            "lpr_tpu_torch.tools.validate_autobatch"} <= names
