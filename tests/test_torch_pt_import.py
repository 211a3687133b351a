"""The reference's pickled-``Model`` checkpoints (``.pt``) in the port,
against the JAX package, on the CPU: ``lpr_tpu_torch.weights.torch_ckpt``
and ``lpr_tpu_torch.models.yolo.load_yolo_torch`` against
``lpr_tpu.weights.torch_ckpt`` and ``lpr_tpu.models.yolo.load_yolo_torch``
on checkpoints the tests write (:mod:`tests.pt_fixture`: stand-in classes
under the reference's module names, one float16 and one bfloat16 tensor),
the unpickler's safety, and the apps that take a ``.pt``."""

import os
import pickle
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.models import yolo as jyolo
from lpr_tpu.weights import torch_ckpt as jckpt
from lpr_tpu.weights.checkpoint import _flatten
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.models.detector import load_char_detector
from lpr_tpu_torch.weights import torch_ckpt as tckpt
from lpr_tpu_torch.weights.checkpoint import load_state, params_from_jax

from .pt_fixture import write_yolo_pt
from .test_torch_zoo import MODULE_ROWS, _module_spec, rand_params
from .torch_ref import CHAR

CHAR_NAMES = [f"c{i}" for i in range(36)]


def _char_pt(tmp_path, mixed=True, **kw):
    """checkpoints/char_ocr_synth.npz as a char.pt (Focus, SPP, C3TR); with
    ``mixed`` its stem conv in float16 and a batch-norm scale in
    bfloat16."""
    state, side = load_state(CHAR)
    if mixed:
        kw.update(half="model.0.conv.conv.weight",
                  bf16="model.2.cv1.bn.weight")
    return write_yolo_pt(
        str(tmp_path / "char.pt"), tyolo.char_ocr_spec(), (8,),
        state, CHAR_NAMES, anchors=side["__anchors__"], **kw)


def _yolov5n_pt(tmp_path, seed=0, name="plate.pt", **kw):
    """A seeded random yolov5n (nc=11, the plate detector's head; the v6
    stem, SPPF, three scales), one head bias in float16 and the stem's
    batch-norm shift in bfloat16."""
    spec = jyolo.yolov5_spec(nc=11, depth=0.33, width=0.25)
    state = params_from_jax(rand_params(jyolo.build_yolo(
        spec, strides=(8, 16, 32)), seed=seed))
    return write_yolo_pt(
        str(tmp_path / name), spec, (8, 16, 32), state,
        [f"p{i}" for i in range(11)], half="model.24.m.1.bias",
        bf16="model.0.bn.bias", **kw)


MAKERS = {"char": _char_pt, "yolov5n": _yolov5n_pt}


def _assert_state_equal(state, jparams):
    ref = _flatten(jparams)
    assert sorted(state) == sorted(ref)
    for k, v in ref.items():
        assert state[k].dtype == np.float32 and state[k].shape == v.shape, k
        np.testing.assert_array_equal(state[k], v, err_msg=k)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("which", sorted(MAKERS))
def test_pt_state_equals_jax_import(which, fuse, tmp_path):
    """The port's flat state of a .pt equals the flattened params of the
    JAX load_yolo_torch, key for key and bit for bit (batch norm folded
    with fuse, kept under bn/* without); the spec, class names, strides and
    anchors are the JAX loader's."""
    path = MAKERS[which](tmp_path)
    model, state, ck = tyolo.load_yolo_torch(path, fuse=fuse, device="cpu")
    jm, jp, jck = jyolo.load_yolo_torch(path, fuse=fuse)
    _assert_state_equal(state, jp)
    assert any(k.endswith("/bn/gamma") for k in state) is not fuse
    for f in ("nc", "depth_multiple", "width_multiple", "anchors",
              "backbone", "head", "ch"):
        assert getattr(model.spec, f) == getattr(jm.spec, f), f
    assert ck.names == jck.names and len(ck.names) == model.nc
    assert model.strides == jm.strides
    np.testing.assert_array_equal(model.anchors, jm.anchors)
    np.testing.assert_array_equal(ck.stride, jck.stride)


@pytest.mark.parametrize("which", sorted(MAKERS))
def test_pt_model_head_matches_jax(which, tmp_path):
    """The .pt-imported model's raw head and decoded predictions on one
    seeded (2, 64, 64, 3) input match the JAX model on the same file:
    within 1e-4 (float32 rounding through the layers; the zoo's parity
    bound), the predictions (pixels) within 1e-4 + 1e-5 relative."""
    path = MAKERS[which](tmp_path)
    model, _, _ = tyolo.load_yolo_torch(path, device="cpu")
    jm, jp, _ = jyolo.load_yolo_torch(path)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    jpred, jraws = jax.jit(lambda p, v: jm.apply(p, v))(jp, jnp.asarray(x))
    with torch.inference_mode():
        pred, raws = model(torch.from_numpy(x), decode=True)
    for g, r in zip(raws, jraws):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("name", sorted(MODULE_ROWS))
def test_pt_import_of_each_builder_module_equals_jax(name, tmp_path):
    """Every builder module the two detectors do not use (Focus, DWConv,
    Bottleneck, BottleneckCSP with its standalone batch norm, C3SPP,
    C3Ghost, GhostConv, GhostBottleneck at stride 1 and 2, Contract,
    Expand), random weights written as a .pt whose EMA model the loaders
    prefer: the flat state equals the JAX import's bit for bit, fused and
    not."""
    spec, strides = _module_spec(name)
    state = params_from_jax(rand_params(jyolo.build_yolo(spec,
                                                         strides=strides)))
    path = write_yolo_pt(str(tmp_path / "m.pt"), spec, strides, state,
                         ["a", "b", "c"], ema=True)
    for fuse in (True, False):
        _, got, ck = tyolo.load_yolo_torch(path, fuse=fuse, device="cpu")
        _assert_state_equal(got, jyolo.load_yolo_torch(path, fuse=fuse)[1])
        assert ck.model is ck.raw["ema"]


def test_pt_ensemble_matches_jax(tmp_path):
    """A list of two .pt files gives a YoloEnsemble whose predictions (the
    two models' concatenated) match the JAX YoloEnsemble's within 1e-4 +
    1e-5 relative, with the last checkpoint's names and the coarsest
    stride."""
    spec, strides = _module_spec("Bottleneck")
    paths = []
    for seed in (0, 1):
        state = params_from_jax(rand_params(
            jyolo.build_yolo(spec, strides=strides), seed=seed))
        paths.append(write_yolo_pt(str(tmp_path / f"m{seed}.pt"),
                                   spec, strides, state,
                                   [f"s{seed}{i}" for i in range(3)]))
    ens, states, ck = tyolo.load_yolo_torch(paths, device="cpu")
    jens, jps, jck = jyolo.load_yolo_torch(paths)
    assert isinstance(ens, tyolo.YoloEnsemble) and len(states) == 2
    assert ck.names == jck.names == ["s10", "s11", "s12"]
    assert ens.stride == jens.stride
    x = np.random.RandomState(2).rand(2, 32, 48, 3).astype(np.float32)
    jpred, _ = jax.jit(lambda p, v: jens.apply(p, v))(jps, jnp.asarray(x))
    with torch.inference_mode():
        pred, _ = ens(torch.from_numpy(x))
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5,
                               atol=1e-4)


class _Boom:
    """A class whose reconstruction would run code: unpickling it for real
    imports this module and calls ``os.system``."""

    def __init__(self, cmd):
        self.cmd = cmd

    def __reduce__(self):
        return (os.system, (self.cmd,))


class _Ctor:
    """A class the pickle names and calls, whose constructor writes a
    file."""

    def __init__(self, path):
        with open(path, "w") as f:
            f.write("ran")

    def __reduce__(self):
        return (_Ctor, (str(self._path),))


@pytest.mark.parametrize("what", ["os.system", "class with __reduce__"])
def test_unpickler_runs_no_pickled_code(what, tmp_path):
    """A checkpoint whose pickle calls os.system, or constructs a class
    from a module the reader would import: the port's reader returns a
    Stub named for it and runs nothing; load_state_dict refuses it."""
    flag = tmp_path / "ran"
    path = str(tmp_path / "evil.pt")
    if what == "os.system":
        obj, name = _Boom(f"touch {flag}"), os.system.__module__ + ".system"
    else:
        obj = _Ctor.__new__(_Ctor)
        obj._path = flag
        name = f"{_Ctor.__module__}._Ctor"
    torch.save({"model": obj, "w": torch.ones(2)}, path)
    got = tckpt.load_checkpoint(path)
    assert not flag.exists()
    assert isinstance(got["model"], tckpt.Stub)
    assert got["model"]._stub_name == name
    assert got["model"]._stub_args == (str(flag) if what != "os.system"
                                       else f"touch {flag}",)
    torch.testing.assert_close(got["w"], torch.ones(2))
    with pytest.raises(ValueError, match="not a plain state-dict"):
        tckpt.load_state_dict(path)
    assert not flag.exists()


def test_numpy2_scalars_are_stubs_as_in_the_jax_reader(tmp_path):
    """numpy 2 pickles a YOLOv5 checkpoint's best_fitness (np.float64) as
    numpy._core.multiarray.scalar, which neither reader allows: both
    return a Stub of that name (the JAX allow-list names numpy.core only);
    a numpy-1 scalar pickle (numpy.core.multiarray.scalar) decodes in
    both."""
    path = _char_pt(tmp_path)
    got = tckpt.load_checkpoint(path)["best_fitness"]
    ref = jckpt.load_checkpoint(path)["best_fitness"]
    assert isinstance(got, tckpt.Stub) and isinstance(ref, jckpt.Stub)
    assert got._stub_name == ref._stub_name == "numpy._core.multiarray.scalar"
    # the numpy-1 form: the same BINGLOBAL under the module name numpy 1 used
    raw = pickle.dumps(np.float64(0.25), protocol=2).replace(
        b"numpy._core.multiarray", b"numpy.core.multiarray")
    zpath = str(tmp_path / "np1.pt")
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.writestr("archive/data.pkl", raw)
    assert tckpt.load_checkpoint(zpath) == jckpt.load_checkpoint(zpath) == 0.25


def test_load_state_dict_reads_what_the_jax_reader_reads(tmp_path):
    """A plain state dict in the reference trainers' wrapper, with float16
    and bfloat16 tensors, through the restricted unpickler: the values of
    the JAX load_state_dict, float16/bfloat16 as float32, other dtypes as
    stored."""
    rng = np.random.RandomState(0)
    sd = {"a.weight": torch.from_numpy(rng.rand(3, 2).astype(np.float32)),
          "a.half": torch.from_numpy(rng.rand(4).astype(np.float32)).half(),
          "a.bf16": torch.from_numpy(rng.rand(5).astype(np.float32)
                                     ).bfloat16(),
          "bn.num_batches_tracked": torch.tensor(3),
          "view": torch.arange(12.0).reshape(3, 4)[:, 1]}
    path = str(tmp_path / "sd.pth")
    torch.save({"model_state_dict": sd, "epoch": 1}, path)
    got = tckpt.load_state_dict(path)
    ref = jckpt.load_state_dict(path)
    assert sorted(got) == sorted(ref) == sorted(sd)
    for k in sd:
        want = np.asarray(ref[k]).astype(
            np.float32 if sd[k].is_floating_point() else ref[k].dtype)
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_load_char_detector_and_ocr_take_a_pt(tmp_path):
    """load_char_ocr and load_char_detector on a char.pt of the npz's
    float32 weights give the npz's model: its raw head bit for bit (the
    .pt's batch norm folded at import, the npz's at load, by one function)
    with the file's names, and its detections on a plate crop."""
    from lpr_tpu_torch import imageio

    path = _char_pt(tmp_path, mixed=False)
    model, _, ck = tyolo.load_char_ocr(path, device="cpu")
    npz_model, npz_state, npz_ck = tyolo.load_char_ocr(CHAR, device="cpu")
    assert ck.names == CHAR_NAMES and len(npz_ck.names) == 36
    assert sorted(npz_state) == sorted(load_state(CHAR)[0])
    x = torch.from_numpy(np.random.RandomState(3).rand(1, 64, 64, 3)
                         .astype(np.float32))
    with torch.inference_mode():
        for a, b in zip(model(x), npz_model(x)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    crop = imageio.read_rgb(os.path.join(
        os.path.dirname(__file__), "fixtures", "real_plates2", "51G18593.png"))
    det = load_char_detector(path, device="cpu").detect(crop)
    want = load_char_detector(CHAR, device="cpu").detect(crop)
    assert det.names == CHAR_NAMES and len(want) >= 4
    np.testing.assert_array_equal(det.boxes, want.boxes)
    np.testing.assert_array_equal(det.scores, want.scores)
    np.testing.assert_array_equal(det.classes, want.classes)
