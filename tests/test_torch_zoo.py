"""The rest of the model zoo against the JAX package, on the CPU, in
float32 (JAX at 'highest'): the YOLO builder's modules, the P6 sizes and
the repo's other plate checkpoints, test-time augmentation and the
ensemble, the Detector wrapper, the CycleGAN forwards, the LPSR variants,
the torch -> HWIO helpers and the ops they need.  Weights cross from the
JAX loaders, or as random numpy arrays in the structure of the JAX
``init`` (:func:`rand_params`), through ``params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.models import cyclegan as jgan
from lpr_tpu.models import lpsr_variants as jvar
from lpr_tpu.models import yolo as jyolo
from lpr_tpu.ops import nn as jnn
from lpr_tpu.weights import convert as jcvt
from lpr_tpu_torch.models import cyclegan as tgan
from lpr_tpu_torch.models import lpsr_variants as tvar
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.models.detector import Detector, load_char_detector
from lpr_tpu_torch.ops import nn as tnn
from lpr_tpu_torch.weights import convert as tcvt
from lpr_tpu_torch.weights.checkpoint import params_from_jax

from .torch_ref import CHAR, PLATE

KEY = jax.random.PRNGKey(0)


def _shapes(model_or_fn, *args):
    init = model_or_fn.init if hasattr(model_or_fn, "init") else model_or_fn
    return jax.eval_shape(lambda k: init(k, *args), KEY)


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def rand_params(model_or_fn, *args, seed: int = 0):
    """A random parameter pytree of the structure ``init`` builds, made
    with numpy (``init`` under jit compiles for ~15 s a model on the CPU):
    conv and linear weights uniform in +-1/sqrt(fan in), batch-norm scales
    and variances in [0.5, 1.5], shifts, means, biases and vectors small
    and signed."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = _key(path).rsplit("/", 1)[-1]
        if name in ("gamma", "var", "alpha"):
            v = rng.uniform(0.5, 1.5, s.shape)
        elif len(s.shape) >= 2:
            v = rng.uniform(-1, 1, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            v = rng.uniform(-0.1, 0.1, s.shape)
        return np.asarray(v, s.dtype)

    return jax.tree_util.tree_map_with_path(leaf,
                                            _shapes(model_or_fn, *args))


def npz_params(path: str, model_or_fn, *args):
    """``lpr_tpu.weights.checkpoint.load_params`` into the structure of
    ``init`` without running it: each leaf the npz entry at its key path,
    cast to the template's dtype (float32)."""
    with np.load(path) as data:
        return jax.tree_util.tree_map_with_path(
            lambda p, s: np.asarray(data[_key(p)]).astype(s.dtype),
            _shapes(model_or_fn, *args))


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


# One builder row a case, after a Conv 3->16 k3 s2 stem (Focus is the
# stem itself); the Detect head reads the module's output.
MODULE_ROWS = {
    "Focus": [(-1, 1, "Focus", [16, 3])],
    "DWConv": [(-1, 1, "DWConv", [32, 3, 1])],
    "Bottleneck": [(-1, 1, "Bottleneck", [16])],
    "BottleneckCSP": [(-1, 2, "BottleneckCSP", [32])],
    "C3SPP": [(-1, 1, "C3SPP", [32, [3, 5, 7]])],
    "C3Ghost": [(-1, 2, "C3Ghost", [32])],
    "GhostConv": [(-1, 1, "GhostConv", [32, 3, 2])],
    "GhostBottleneck s1": [(-1, 1, "GhostBottleneck", [16, 3, 1])],
    "GhostBottleneck s2": [(-1, 1, "GhostBottleneck", [32, 5, 2])],
    "Contract": [(-1, 1, "Contract", [2])],
    "Expand": [(-1, 1, "Expand", [2])],
}


def _module_spec(name):
    rows = MODULE_ROWS[name]
    stem = [] if name == "Focus" else [(-1, 1, "Conv", [16, 3, 2])]
    stride = {"Focus": 2, "GhostConv": 4, "GhostBottleneck s2": 4,
              "Contract": 4, "Expand": 1}.get(name, 2)
    spec = jyolo.YoloSpec(
        nc=3, depth_multiple=1.0, width_multiple=1.0,
        anchors=[[10, 13, 16, 30, 33, 23]], backbone=tuple(stem + rows),
        head=(([len(stem + rows) - 1], 1, "Detect", ["nc", "anchors"]),))
    return spec, (stride,)


@pytest.mark.parametrize("name", sorted(MODULE_ROWS))
def test_builder_module_matches_jax(name):
    """Each builder module the main path does not use, built by both
    builders from one spec, random weights in the JAX init's structure
    (:func:`rand_params`) through the bridge, at
    (2, 32, 48): the raw head within 1e-4 (float32 rounding through three
    or four convolutions) and the decoded predictions within 1e-4 + 1e-5
    relative (pixels)."""
    spec, strides = _module_spec(name)
    jm = jyolo.build_yolo(spec, strides=strides)
    jp = rand_params(jm)
    tm = tyolo.build_yolo(spec, strides=strides).load_state(
        params_from_jax(jp))
    x = np.random.RandomState(1).rand(2, 32, 48, 3).astype(np.float32)
    jpred, jraws = jax.jit(lambda p, v: jm.apply(p, v))(jp, jnp.asarray(x))
    with torch.inference_mode():
        pred, raws = tm(_torch(x), decode=True)
    for g, r in zip(raws, jraws):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5,
                               atol=1e-4)


def test_builder_takes_every_module_name_of_the_jax_builder():
    """The port's builder knows every name of lpr_tpu's _MODULE_NAMES, and
    builds and runs a Classify-headed spec (which the JAX builder, needing
    a Detect's anchors, cannot build) whose head matches the JAX
    Classify layer on the same input (1e-5)."""
    assert set(tyolo._MODULES) == set(jyolo._MODULE_NAMES)
    spec = jyolo.YoloSpec(
        nc=5, depth_multiple=1.0, width_multiple=1.0, anchors=None,
        backbone=((-1, 1, "Conv", [16, 3, 2]), (-1, 1, "Conv", [32, 3, 2])),
        head=(([0, 1], 1, "Classify", [5]),))
    jlay = jyolo.Classify(16 + 32, 5)
    jp_conv = [rand_params(jyolo.Conv(3, 16, 3, 2), seed=1),
               rand_params(jyolo.Conv(16, 32, 3, 2), seed=2)]
    jp_cls = rand_params(jlay)
    tm = tyolo.build_yolo(spec).load_state(params_from_jax(
        jp_conv + [jp_cls]))
    x = np.random.RandomState(2).rand(2, 16, 24, 3).astype(np.float32)
    f0 = jyolo.Conv(3, 16, 3, 2)(jp_conv[0], jnp.asarray(x))
    f1 = jyolo.Conv(16, 32, 3, 2)(jp_conv[1], f0)
    ref = jlay(jp_cls, [f0, f1])
    with torch.inference_mode():
        got = tm(_torch(x))
    assert tuple(got.shape) == (2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_ghost_modules_match_the_torch_golden():
    """GhostConv and two GhostBottlenecks (s=1, s=2) on the reference torch
    modules' golden output (tests/fixtures/ghost_golden.npz), weights
    through JAX's import_torch and the bridge, within its 2e-5; the second
    GhostConv of a GhostBottleneck has no activation (the round-1 bug that
    tests/test_yolo.py names)."""
    z = np.load("tests/fixtures/ghost_golden.npz")
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd.")}
    jl = [jyolo.GhostConv(8, 16, 3, 1), jyolo.GhostBottleneck(16, 16, 3, 1),
          jyolo.GhostBottleneck(16, 24, 5, 2)]
    state = params_from_jax(
        [l.import_torch(sd, str(i)) for i, l in enumerate(jl)])
    layers = [tyolo.GhostConv(8, 16, 3, 1), tyolo.GhostBottleneck(16, 16, 3, 1),
              tyolo.GhostBottleneck(16, 24, 5, 2)]
    for i, l in enumerate(layers):
        l.load(state, str(i))
    assert layers[1].g2.act == "none" and layers[1].g2.cv2.act == "none"
    y = _torch(np.transpose(z["x"], (0, 2, 3, 1)))
    with torch.inference_mode():
        for l in layers:
            y = l(y)
    np.testing.assert_allclose(y.numpy(), np.transpose(z["y"], (0, 2, 3, 1)),
                               rtol=0, atol=2e-5)


def test_yolov5_p6_matches_jax():
    """yolov5("n6") (4 scales, strides 8-64, random weights) at (1, 128,
    128): the decoded predictions within 1e-4 + 1e-5 relative (a decoded
    wh reaches ~10^3 px, where one float32 ulp is 6e-5); every named size
    builds."""
    jm = jyolo.yolov5("n6", nc=4)
    jp = rand_params(jm)
    tm = tyolo.yolov5("n6", nc=4).load_state(params_from_jax(jp))
    assert tm.strides == jm.strides == (8, 16, 32, 64)
    x = np.random.RandomState(3).rand(1, 128, 128, 3).astype(np.float32)
    jpred, _ = jax.jit(lambda p, v: jm.apply(p, v))(jp, jnp.asarray(x))
    with torch.inference_mode():
        pred, raws = tm(_torch(x), decode=True)
    assert len(raws) == 4
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5,
                               atol=1e-4)
    for size in ("n", "s", "m", "l", "x", "s6", "x6"):
        m = tyolo.yolov5(size)
        assert [type(l).__name__ for l in m.layers] == [
            type(l).__name__ for l in jyolo.yolov5(size).layers]
    with pytest.raises(ValueError, match="unknown yolov5 size"):
        tyolo.yolov5("q")


@pytest.mark.parametrize("path,size", [("checkpoints/demo_plate.npz", "n"),
                                       ("checkpoints/demo_plate_s.npz", "s")])
def test_other_plate_checkpoints_load_and_match_jax(path, size):
    """demo_plate.npz (yolov5n) and demo_plate_s.npz through
    load_plate_detector(size=): the raw head at (1, 128, 192) within 2e-3,
    the float detector's bound (tests/test_torch_models.py)."""
    jm = jyolo.yolov5(size, nc=11)
    jp = npz_params(path, jm)
    tm = tyolo.load_plate_detector(path, device="cpu", size=size)
    x = np.random.RandomState(4).rand(1, 128, 192, 3).astype(np.float32)
    ref = jax.jit(lambda p, v: jm.apply(p, v, decode=False))(
        jp, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(_torch(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=2e-3)


@pytest.fixture(scope="module")
def demo_n():
    jm = jyolo.yolov5("n", nc=11)
    jp = npz_params("checkpoints/demo_plate.npz", jm)
    tm = tyolo.load_plate_detector("checkpoints/demo_plate.npz",
                                   device="cpu", size="n")
    return jm, jp, tm


@pytest.mark.parametrize("scale", [0.83, 0.67])
def test_downscale_is_the_jax_antialiased_resize(scale):
    """apply_augmented's downscales: jax.image.resize's bilinear
    antialiases, and so does the port's resize_bilinear (1e-5)."""
    x = np.random.RandomState(5).rand(1, 96, 160, 3).astype(np.float32)
    nh, nw = int(np.ceil(96 * scale / 32) * 32), int(np.ceil(160 * scale
                                                            / 32) * 32)
    ref = jax.image.resize(jnp.asarray(x), (1, nh, nw, 3), "bilinear")
    from lpr_tpu_torch.ops.image import resize_bilinear

    np.testing.assert_allclose(resize_bilinear(_torch(x), (nh, nw)).numpy(),
                               np.asarray(ref), rtol=0, atol=1e-5)


def test_apply_augmented_matches_jax(demo_n):
    """Test-time augmentation (scales 1, 0.83 flipped, 0.67; tails
    clipped) with demo_plate.npz at (1, 96, 160): within 2e-3, the float
    detector's bound, on boxes and scores."""
    jm, jp, tm = demo_n
    x = np.random.RandomState(6).rand(1, 96, 160, 3).astype(np.float32)
    ref = jax.jit(lambda p, v: jyolo.apply_augmented(jm, p, v))(
        jp, jnp.asarray(x))
    with torch.inference_mode():
        got = tyolo.apply_augmented(tm, _torch(x))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-3)


def test_ensemble_matches_jax(demo_n):
    """YoloEnsemble of demo_plate.npz and a random yolov5n: the two decoded
    predictions concatenated, within 2e-3; stride from the coarsest."""
    jm, jp, tm = demo_n
    jm2 = jyolo.yolov5("n", nc=11)
    jp2 = rand_params(jm2)
    tm2 = tyolo.yolov5("n", nc=11).load_state(params_from_jax(jp2))
    jens, tens = jyolo.YoloEnsemble([jm, jm2]), tyolo.YoloEnsemble([tm, tm2])
    assert tens.stride == jens.stride and tens.nc == jens.nc
    x = np.random.RandomState(7).rand(1, 64, 96, 3).astype(np.float32)
    ref, _ = jax.jit(lambda p, v: jens.apply(p, v))([jp, jp2],
                                                     jnp.asarray(x))
    with torch.inference_mode():
        got, none = tens(_torch(x))
    assert none is None and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-3)


def test_detector_matches_jax():
    """Detector.detect_batch with plate_det640 at 320x320, float32, on two
    synthetic frames: the same detections, boxes equal after
    round (a coordinate within float32 rounding of a .5 could round apart:
    none here), scores within 1e-4.  The frames: the port's numpy street
    scenes (lpr_tpu_torch/tools/synth.py).  load_char_detector takes the
    npz checkpoint, and a .pt goes to the pickled-module reader (a missing
    one raises FileNotFoundError there; tests/test_torch_pt_import.py loads
    one)."""
    from lpr_tpu.models.detector import Detector as JDetector
    from lpr_tpu.pipeline.recognizer import DETECT_CLASSES
    from lpr_tpu_torch.tools.synth import synth_frames

    jm = jyolo.build_yolo(jyolo.yolov5_spec(nc=11), strides=(8, 16, 32))
    jp = npz_params(PLATE, jm)
    frames = synth_frames(2, (240, 320), seed=0)
    jd = JDetector(jm, jp, DETECT_CLASSES, size=(320, 320),
                   dtype=jnp.float32)
    td = Detector(tyolo.load_plate_detector(PLATE, device="cpu"),
                  DETECT_CLASSES, size=(320, 320), dtype=torch.float32,
                  device="cpu")
    ref, got = jd.detect_batch(frames), td.detect_batch(frames)
    assert sum(len(r) for r in ref) > 0
    for r, g in zip(ref, got):
        assert len(g) == len(r)
        np.testing.assert_array_equal(g.classes, r.classes)
        np.testing.assert_array_equal(g.boxes, r.boxes)
        np.testing.assert_allclose(g.scores, r.scores, rtol=0, atol=1e-4)
        assert [row[0] for row in g.tolist()] == [row[0] for row in
                                                  r.tolist()]
    cd = load_char_detector(CHAR, device="cpu", dtype=torch.float32)
    assert len(cd.names) == 36 and cd.size == (128, 128)
    with pytest.raises(FileNotFoundError, match="char.pt"):
        load_char_detector("weights/char.pt", device="cpu")


@pytest.mark.parametrize("path", ["checkpoints/cyclegan_real_g.npz",
                                  "checkpoints/demo_cyclegan_g.npz"])
def test_generator_matches_jax(path):
    """The CycleGAN generator on the repo's fp16 checkpoints (cast to
    float32 as the JAX loader casts them) at (1, 32, 96, 3) in [-1, 1]:
    within 1e-4 on the tanh output, float32 rounding through 24 convs and
    23 instance norms."""
    jp = npz_params(path, jgan.generator_init)
    gen = tgan.load_generator(path, device="cpu")
    x = np.random.RandomState(8).uniform(-1, 1, (1, 32, 96, 3)
                                         ).astype(np.float32)
    ref = jax.jit(jgan.generator_apply)(jp, jnp.asarray(x))
    with torch.inference_mode():
        got = tgan.generator_apply(gen, _torch(x))
    assert tuple(got.shape) == (1, 32, 96, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_generator_from_torch_matches_jax():
    """generator_from_torch on a torch-layout state dict made with numpy:
    the same HWIO weights as JAX's import, array for array."""
    rng = np.random.RandomState(9)
    jp = _shapes(jgan.generator_init)
    sd = {}
    for key, i in (("head", 1), ("down0", 4), ("down1", 7), ("up0", 20),
                   ("up1", 23), ("tail", 26)):
        sd[f"model.{i}.weight"] = rng.randn(
            *jp[key]["w"].shape[::-1]).astype(np.float32)
        sd[f"model.{i}.bias"] = rng.randn(
            jp[key]["b"].shape[0]).astype(np.float32)
    for j, i in enumerate(range(10, 19)):
        for c, blk in (("c0", 1), ("c1", 5)):
            shape = jp["blocks"][j][c]["w"].shape[::-1]
            sd[f"model.{i}.conv_block.{blk}.weight"] = rng.randn(
                *shape).astype(np.float32)
            sd[f"model.{i}.conv_block.{blk}.bias"] = rng.randn(
                shape[0]).astype(np.float32)
    ref = params_from_jax(jax.device_get(jgan.generator_from_torch(sd)))
    got = tgan.generator_from_torch(sd)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_discriminator_matches_jax():
    """The PatchGAN with spectral norm at (2, 64, 64, 3), update_sn=True:
    the logits map and the new power-iteration vectors within 1e-5, the
    untouched params the same; update_sn=False keeps the old vectors."""
    jp = rand_params(jgan.discriminator_init)
    x = np.random.RandomState(10).uniform(-1, 1, (2, 64, 64, 3)
                                          ).astype(np.float32)
    ref, jnew = jax.jit(lambda p, v: jgan.discriminator_apply(
        p, v, update_sn=True))(jp, jnp.asarray(x))
    p = {k: _torch(v) for k, v in params_from_jax(jp).items()}
    got, new = tgan.discriminator_apply(p, _torch(x), update_sn=True)
    assert tuple(got.shape) == np.asarray(ref).shape == (2, 6, 6, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    jnew = params_from_jax(jax.device_get(jnew))
    assert sorted(new) == sorted(jnew)
    for k in jnew:
        np.testing.assert_allclose(new[k].numpy(), jnew[k], rtol=0, atol=1e-5)
    _, same = tgan.discriminator_apply(p, _torch(x), update_sn=False)
    assert all(same[k] is p[k] for k in p)


VCFG = dict(num_features=8, growth_rate=4, num_blocks=2, num_layers=2)


@pytest.mark.parametrize("ver", ["ver01", "ver02", "ver03"])
def test_lpsr_variant_matches_jax(ver):
    """ver01-03 at a small width (8 features, 2 blocks of 2 layers, 2x)
    from the JAX init at (2, 16, 24, 3): within 1e-5."""
    jcfg = jvar.VariantConfig(**VCFG)
    jp = rand_params(getattr(jvar, f"{ver}_init"), jcfg)
    tm = getattr(tvar, ver.capitalize())(params_from_jax(jp),
                                         tvar.VariantConfig(**VCFG))
    x = np.random.RandomState(11).rand(2, 16, 24, 3).astype(np.float32)
    ref = jax.jit(getattr(jvar, f"{ver}_apply"))(jp, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(_torch(x))
    assert tuple(got.shape) == np.asarray(ref).shape == (2, 32, 48, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("fn", ["conv_w", "dw_conv_w", "linear_w", "vec"])
def test_convert_matches_jax(fn):
    """The torch -> HWIO helpers, array for array."""
    shape = {"conv_w": (6, 4, 3, 3), "dw_conv_w": (5, 1, 3, 3),
             "linear_w": (7, 3), "vec": (9,)}[fn]
    t = np.random.RandomState(12).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(getattr(tcvt, fn)(t),
                                  getattr(jcvt, fn)(t))
    sd = {"a.w": t, "a.b": t, "b.w": t}
    assert sorted(tcvt.subdict(sd, "a.")) == sorted(jcvt.subdict(sd, "a."))


@pytest.mark.parametrize("op", ["instance_norm", "reflect_pad2d",
                                "leaky_relu", "avg_pool2d",
                                "global_avg_pool", "relu"])
def test_new_ops_match_jax(op):
    """The ops the new models need, NHWC, within 1e-6."""
    x = np.random.RandomState(13).randn(2, 9, 11, 5).astype(np.float32)
    args = {"reflect_pad2d": (3,), "avg_pool2d": (3, 2, 1),
            "leaky_relu": (0.1,)}.get(op, ())
    ref = getattr(jnn, op)(jnp.asarray(x), *args)
    got = getattr(tnn, op)(_torch(x), *args)
    assert tuple(got.shape) == np.asarray(ref).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
