"""ONNX in the port against the JAX package, on the CPU: the emitters'
bytes (``lpr_tpu_torch.weights.onnx_export`` against
``lpr_tpu.weights.onnx_export`` on the same weights), the reader
(``onnx_import``), the executor (``onnx_run``, PyTorch, against the JAX
package's numpy/lax executor) op by op and on whole graphs, and
``load_lpsr`` of an ``.onnx``."""

import numpy as np
import pytest
import torch

from lpr_tpu.models import lpsr as jlpsr
from lpr_tpu.models import yolo as jyolo
from lpr_tpu.weights import onnx_export as jexport
from lpr_tpu.weights import onnx_import as jimport
from lpr_tpu.weights import onnx_run as jrun
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.weights import onnx_export as texport
from lpr_tpu_torch.weights import onnx_import as timport
from lpr_tpu_torch.weights import onnx_run as trun
from lpr_tpu_torch.weights.checkpoint import load_state

from .test_torch_pt_import import _yolov5n_pt
from .test_torch_zoo import npz_params
from .torch_ref import CHAR, LPSR, PLATE

GRAPHS = ["lpsr", "char", "plate", "yolov5n .pt"]


def _emit(which, tmp_path):
    """Both emitters on the same weights: (port path, JAX path, port model
    or None, its flat state).  The char OCR (Focus, SPP, C3TR) and the
    plate detector (v6 stem, SPPF) from their npz (batch norm under bn/*,
    folded at emit), a random yolov5n through a .pt import (batch norm
    folded at import), LPSR from its npz."""
    tp, jp_ = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    if which == "lpsr":
        state, _ = load_state(LPSR)
        texport.export_lpsr_onnx(state, tp)
        jexport.export_lpsr_onnx(npz_params(LPSR, lambda k: jlpsr.lpsr_init(
            k, jlpsr.LPSRConfig())), jp_)
        return tp, jp_, None, state
    if which == "yolov5n .pt":
        path = _yolov5n_pt(tmp_path)
        tm, state, _ = tyolo.load_yolo_torch(path, device="cpu")
        jm, jparams, _ = jyolo.load_yolo_torch(path)
        hw = (64, 96)
    else:
        path = CHAR if which == "char" else PLATE
        state, side = load_state(path)
        anchors = side.get("__anchors__")
        strides = (8,) if which == "char" else (8, 16, 32)
        spec = "char_ocr_spec" if which == "char" else "yolov5_spec"
        kw = {} if which == "char" else {"nc": 11}
        jm = jyolo.build_yolo(getattr(jyolo, spec)(**kw),
                              ckpt_anchors=anchors, strides=strides)
        tm = tyolo.build_yolo(getattr(tyolo, spec)(**kw),
                              ckpt_anchors=anchors, strides=strides
                              ).load_state(state)
        jparams = npz_params(path, jm)
        hw = (64, 64) if which == "char" else (64, 96)
    texport.export_yolo_onnx(tm, state, tp, hw=hw)
    jexport.export_yolo_onnx(jm, jparams, jp_, hw=hw)
    return tp, jp_, tm, state


@pytest.mark.parametrize("which", GRAPHS)
def test_onnx_emit_writes_the_jax_emitters_bytes(which, tmp_path):
    """The port's emitter, from the flat state (the plain k6/s2 stem, the
    batch norm folded at emit time where the state keeps it), writes the
    JAX emitter's file byte for byte."""
    tp, jp_, _, _ = _emit(which, tmp_path)
    with open(tp, "rb") as a, open(jp_, "rb") as b:
        got, ref = a.read(), b.read()
    assert len(got) > 10_000 and got == ref


@pytest.mark.parametrize("which", ["lpsr", "char", "yolov5n .pt"])
def test_run_onnx_matches_jax_and_the_model(which, tmp_path):
    """The port's executor on an emitted graph against the JAX executor
    and against the port's own forward, float32: LPSR (at 32x192 and at
    30x190, the dynamic pad to a multiple of 4, whose output both keep at
    the padded size) within 1e-5; the detectors' predictions within 1e-5,
    relative for the pixel coordinates (boxes reach ~100 px, where 1e-5 is
    ~1 float32 ulp)."""
    tp, _, tm, _ = _emit(which, tmp_path)
    if tm is None:
        lpsr = tlpsr.load_lpsr(LPSR, device="cpu")
        tm = lambda v, decode: lpsr(v)            # noqa: E731
    g = timport.load_onnx(tp)
    rng = np.random.RandomState(3)
    shapes = ([(1, 3, 32, 192), (2, 3, 30, 190)] if which == "lpsr" else
              [(2, 3, *((64, 64) if which == "char" else (64, 96)))])
    for shape in shapes:
        x = rng.rand(*shape).astype(np.float32)
        got = trun.run_onnx(g, {"input_image": torch.from_numpy(x)})[0]
        ref = jrun.run_onnx(g, {"input_image": x})[0]
        assert got.device.type == "cpu" and tuple(got.shape) == ref.shape
        tol = dict(rtol=0, atol=1e-5) if which == "lpsr" else dict(
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), ref, **tol)
        xh = torch.from_numpy(x.transpose(0, 2, 3, 1).copy())
        with torch.inference_mode():
            own = tm(xh, decode=True)
        own = own.permute(0, 3, 1, 2) if which == "lpsr" else own[0]
        np.testing.assert_allclose(got.numpy(), own.numpy(), **tol)


def test_onnx_reader_matches_jax(tmp_path):
    """load_onnx and onnx_to_torch_names of the port read what the JAX
    reader reads: the emitted LPSR graph's initializers (bit for bit),
    nodes with their attributes, inputs and outputs; and negative int64
    initializers (10-byte varints) as negative numbers."""
    state, _ = load_state(LPSR)
    path = str(tmp_path / "lpsr.onnx")
    texport.export_lpsr_onnx(state, path)
    g = texport.OnnxGraph("neg")
    g.const_i64([-1, 0, -(2 ** 40), 7], name="neg")
    out = g.op("Reshape", ["x", "neg"], out="y")
    neg = str(tmp_path / "neg.onnx")
    with open(neg, "wb") as f:
        f.write(g.serialize([texport._value_info("x", [1, 4])],
                            [texport._value_info(out, [4])]))
    for p in (path, neg):
        got, ref = timport.load_onnx(p), jimport.load_onnx(p)
        assert got["nodes"] == ref["nodes"]
        assert (got["inputs"], got["outputs"]) == (ref["inputs"],
                                                   ref["outputs"])
        assert sorted(got["initializers"]) == sorted(ref["initializers"])
        for k, v in ref["initializers"].items():
            assert got["initializers"][k].dtype == v.dtype
            np.testing.assert_array_equal(got["initializers"][k], v)
    assert list(timport.load_onnx(neg)["initializers"]["neg"]) == [
        -1, 0, -(2 ** 40), 7]
    names = timport.onnx_to_torch_names(path)
    assert names.keys() == jimport.onnx_to_torch_names(path).keys()
    assert len([k for k, v in names.items() if v.dtype != np.int64]) == 64


def _one(op, inputs, attrs=None, inits=None):
    n_in = [k for k in inputs if k != ""]
    return {"initializers": dict(inits or {}),
            "nodes": [{"op_type": op, "inputs": list(inputs),
                       "outputs": ["y"], "name": "n", "attrs": attrs or {}}],
            "inputs": n_in, "outputs": ["y"]}


_R = np.random.RandomState(5)
_X4 = _R.randn(2, 4, 7, 9).astype(np.float32)
_I = np.int64
# op cases the emitted graphs do not reach (or reach in one form only):
# (graph, feeds)
OP_CASES = {
    "Conv SAME_UPPER s2 dilated": (_one("Conv", ["x", "w", "b"], {
        "auto_pad": "SAME_UPPER", "strides": [2, 2], "dilations": [2, 1]},
        {"w": _R.randn(3, 4, 3, 2).astype(np.float32),
         "b": _R.randn(3).astype(np.float32)}), {"x": _X4}),
    "Conv asymmetric pads, groups": (_one("Conv", ["x", "w"], {
        "pads": [1, 0, 2, 1], "group": 2},
        {"w": _R.randn(4, 2, 3, 3).astype(np.float32)}), {"x": _X4}),
    "Slice negative step": (_one("Slice", ["x", "s", "e", "a", "st"], None, {
        "s": np.array([-1, 1], _I), "e": np.array([-100, 8], _I),
        "a": np.array([3, 2], _I), "st": np.array([-2, 3], _I)}),
        {"x": _X4}),
    "Gather scalar negative": (_one("Gather", ["x", "i"], {"axis": 1},
                                    {"i": np.array(-1, _I)}), {"x": _X4}),
    "Gather matrix": (_one("Gather", ["x", "i"], {"axis": 3},
                           {"i": np.array([[0, 8], [3, -2]], _I)}),
                      {"x": _X4}),
    "Squeeze": (_one("Squeeze", ["x", "a"], None,
                     {"a": np.array([1], _I)}), {"x": _X4[:, :1]}),
    "Constant": (_one("Constant", [], {"value": _R.randn(3).astype(
        np.float32)}), {}),
    "Identity": (_one("Identity", ["x"]), {"x": _X4}),
    "LeakyRelu": (_one("LeakyRelu", ["x"], {"alpha": 0.1}), {"x": _X4}),
    "MaxPool strided asymmetric": (_one("MaxPool", ["x"], {
        "kernel_shape": [3, 2], "pads": [1, 0, 0, 1], "strides": [2, 2]}),
        {"x": _X4}),
    "Resize nearest": (_one("Resize", ["x", "", "s"], {"mode": "nearest"},
                            {"s": np.array([1, 1, 2, 3], np.float32)}),
                       {"x": _X4}),
    "Pad constant": (_one("Pad", ["x", "p", "v"], None, {
        "p": np.array([0, 1, 2, 0, 0, 0, 1, 3], _I),
        "v": np.array(0.5, np.float32)}), {"x": _X4}),
    "Div integer": (_one("Div", ["x", "d"], None,
                         {"d": np.array([4], _I)}),
                    {"x": np.array([7, -7, 8], _I)}),
    "Mod negative": (_one("Mod", ["x", "d"], None, {"d": np.array([4], _I)}),
                     {"x": np.array([7, -7, 8], _I)}),
    "Softmax": (_one("Softmax", ["x"], {"axis": 1}), {"x": _X4}),
    "Flatten axis 2": (_one("Flatten", ["x"], {"axis": 2}), {"x": _X4}),
    "DepthToSpace DCR": (_one("DepthToSpace", ["x"], {"blocksize": 2}),
                         {"x": _X4}),
    "Unsqueeze attr": (_one("Unsqueeze", ["x"], {"axes": [0, 3]}),
                       {"x": _X4[0, 0]}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_executor_op_matches_jax(case):
    """Each op form the emitted graphs do not cover, in a one-node graph:
    the port's executor gives the JAX executor's shape, dtype class and
    values (float32 within 1e-5, integers exactly)."""
    graph, feeds = OP_CASES[case]
    got = trun.run_onnx(graph, {k: torch.from_numpy(v)
                                for k, v in feeds.items()})[0]
    ref = np.asarray(jrun.run_onnx(graph, feeds)[0])
    assert tuple(got.shape) == ref.shape
    assert got.is_floating_point() == np.issubdtype(ref.dtype, np.floating)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_load_lpsr_from_onnx_equals_the_npz_model(tmp_path):
    """load_lpsr of the emitted .onnx: the state equal to the npz's key for
    key and bit for bit, every buffer of the model equal, and the JAX
    load_lpsr of the same file equal to it."""
    from lpr_tpu.weights.checkpoint import _flatten

    state, _ = load_state(LPSR)
    path = str(tmp_path / "sr.onnx")
    texport.export_lpsr_onnx(state, path)
    got = tlpsr.lpsr_state(path)
    assert sorted(got) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k], err_msg=k)
    ref = _flatten(jlpsr.load_lpsr(path, jlpsr.LPSRConfig()))
    assert sorted(ref) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    a = dict(tlpsr.load_lpsr(path, device="cpu").named_buffers())
    b = dict(tlpsr.load_lpsr(LPSR, device="cpu").named_buffers())
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
