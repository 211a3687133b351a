"""Model export in the port, on the CPU: the reference-layout LPSR state
dict (``lpr_tpu_torch.weights.export_torch`` against
``lpr_tpu.weights.export_torch``), ``torch.export`` programs
(``export_program``: round trips, and the refusal of a trace that reaches
a hand-written kernel) and the export CLI in every format."""

import numpy as np
import pytest
import torch

from lpr_tpu.models import lpsr as jlpsr
from lpr_tpu.weights import export_torch as jexport
from lpr_tpu_torch.cli import export as cli_export
from lpr_tpu_torch.kernels import yolo_front as kf
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.weights import export_program as tprog
from lpr_tpu_torch.weights import export_torch as texport
from lpr_tpu_torch.weights import onnx_import as timport
from lpr_tpu_torch.weights import torch_ckpt as tckpt
from lpr_tpu_torch.weights.checkpoint import load_state, read_npz
from lpr_tpu_torch.weights.onnx_run import run_onnx

from .test_torch_pt_import import _char_pt
from .test_torch_zoo import npz_params
from .torch_ref import CHAR, LPSR, PLATE


def test_lpsr_torch_state_dict_equals_jax(tmp_path):
    """lpsr_to_torch_state_dict of the npz state: the JAX state dict's 158
    keys in its order, shapes and values bit for bit (the dead RDBs zero,
    the shared CSAR repeated, the GA duplicates); saved, the port's and
    the JAX package's .pth readers load it back to the npz's state."""
    state, _ = load_state(LPSR)
    got = texport.lpsr_to_torch_state_dict(state)
    ref = jexport.lpsr_to_torch_state_dict(npz_params(
        LPSR, lambda k: jlpsr.lpsr_init(k, jlpsr.LPSRConfig())))
    assert list(got) == list(ref) and len(got) == 158
    for k in ref:
        assert got[k].dtype == torch.float32, k
        assert got[k].shape == ref[k].shape and torch.equal(got[k], ref[k]), k
    assert not got["rdn.rdbs.6.lff.weight"].any()
    assert torch.equal(got["rdn.rdbs.3.conv_out.weight"],
                       got["rdn.csar.conv_out.weight"])
    path = str(tmp_path / "sr.pth")
    texport.save_lpsr_torch(path, state)
    back = tlpsr.lpsr_state(path)
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k], err_msg=k)
    assert sorted(tckpt.load_state_dict(path)) == sorted(ref)


@pytest.mark.parametrize("which", ["lpsr", "char detector"])
def test_pt2_round_trip_equals_the_forward(which, tmp_path):
    """export_lpsr / export_detector to .pt2, loaded back with load_fn: on
    a new input the program's output equals the module's plain forward
    (LPSR.forward; the detector's decoded predictions) within 1e-6; the
    detector's own forward after the export still runs (its Detect tables
    made under the trace are not kept)."""
    path = str(tmp_path / "m.pt2")
    rng = np.random.RandomState(0)
    if which == "lpsr":
        model = tlpsr.load_lpsr(LPSR, device="cpu")
        tprog.export_lpsr(model, path, batch=2)
        x = torch.from_numpy(rng.rand(2, 32, 192, 3).astype(np.float32))
        want = model(x)
    else:
        model, _, _ = tyolo.load_char_ocr_npz(CHAR, device="cpu")
        tprog.export_detector(model, path, batch=1, hw=(64, 64))
        x = torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32))
        with torch.inference_mode():
            want = model(x, decode=True)[0]
    fn = tprog.load_fn(path)
    with torch.inference_mode():
        got = fn(x)
    assert tuple(got.shape) == tuple(want.shape)
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=1e-6)


def test_export_refuses_a_trace_that_reaches_a_kernel(tmp_path):
    """A trace that reaches a hand-written kernel's wrapper raises, on the
    CPU too, where the wrapper would run its plain version: the plate
    detector with front= (K1), and the int8 detector (I1, I2) through
    export_detector."""
    plate = tyolo.load_plate_detector(PLATE, device="cpu")
    front = kf.front_pack(plate)
    x = torch.rand(1, 64, 64, 3)
    with pytest.raises(RuntimeError, match="yolo_front .*torch.export"):
        tprog.export_fn(lambda v: plate(v, front=front), (x,),
                        str(tmp_path / "k1.pt2"))
    char, _, _ = tyolo.load_char_ocr_npz(CHAR, device="cpu")
    tyolo.quantize_yolo(char)
    with pytest.raises(RuntimeError, match="act_amax|quantize_act"):
        tprog.export_detector(char, str(tmp_path / "i8.pt2"), hw=(64, 64))


def _check_sr(out, fmt):
    state, _ = load_state(LPSR)
    if fmt == "pt2":
        got = tprog.load_fn(out)(torch.zeros(1, 32, 192, 3))
        assert tuple(got.shape) == (1, 32, 192, 1)
        return
    back = (read_npz(out) if fmt == "npz" else tlpsr.lpsr_state(out))
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k], err_msg=k)


@pytest.mark.parametrize("model_type,fmt", [
    ("sr", "onnx"), ("sr", "torch"), ("sr", "npz"), ("sr", "pt2"),
    ("ocr", "onnx"), ("ocr", "npz"), ("ocr", "pt2")])
def test_cli_export_writes_each_format(model_type, fmt, tmp_path, capsys):
    """cli/export with --device cpu, the format from the output's
    extension: sr from the npz (read back equal to it, or a program of
    (1, 32, 192, 3)); ocr from a char.pt (the ONNX graph's predictions
    (1, 512, 41) at the default 128x128, the npz equal to the .pt's fused
    state, a program at --size 64 64, (1, 128, 41))."""
    ext = {"onnx": ".onnx", "torch": ".pth", "npz": ".npz", "pt2": ".pt2"}
    out = str(tmp_path / "out" / f"m{ext[fmt]}")
    weights = LPSR if model_type == "sr" else _char_pt(tmp_path)
    argv = ["--model-type", model_type, "--weights", weights, "--output",
            out, "--device", "cpu"]
    if fmt == "pt2" and model_type == "ocr":
        argv += ["--size", "64", "64"]
    cli_export.main(argv)
    assert capsys.readouterr().out.strip() == (
        f"exported {model_type} ({fmt}) -> {out}")
    if model_type == "sr":
        _check_sr(out, fmt)
    elif fmt == "onnx":
        g = timport.load_onnx(out)
        assert g["inputs"] == ["input_image"]
        assert g["outputs"] == ["predictions"]
        got = run_onnx(g, {"input_image": torch.zeros(1, 3, 128, 128)})[0]
        assert tuple(got.shape) == (1, 512, 41)
    elif fmt == "npz":
        _, state, _ = tyolo.load_yolo_torch(weights, device="cpu")
        back = read_npz(out)
        assert sorted(back) == sorted(state)
        for k in state:
            np.testing.assert_array_equal(back[k], state[k], err_msg=k)
    else:
        got = tprog.load_fn(out)(torch.zeros(1, 64, 64, 3))
        assert tuple(got.shape) == (1, 128, 41)


def test_cli_export_refusals(tmp_path):
    """--format stablehlo (the JAX package's artifact) raises naming pt2;
    --format torch covers the sr model only, as in the JAX CLI."""
    base = ["--weights", LPSR, "--device", "cpu", "--output",
            str(tmp_path / "m.bin")]
    with pytest.raises(SystemExit, match="pt2"):
        cli_export.main(["--model-type", "sr", "--format", "stablehlo",
                         *base])
    with pytest.raises(SystemExit, match="sr model only"):
        cli_export.main(["--model-type", "ocr", "--format", "torch", *base])
