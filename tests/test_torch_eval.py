"""Evaluation against the JAX package on the CPU: the detection metrics,
the edit distance and CER, the plots, the two-path OCR evaluator with the
repo's checkpoints (float32, JAX at 'highest'), and the plain-state-dict
``.pth`` import of LPSR and the CycleGAN generator.  Card-only tests (the
evaluator on the card against the CPU, K2's float32 instance against its
plain version at the evaluator's shapes) are marked ``cuda``."""

import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.eval import harness as jharness
from lpr_tpu.eval import metrics as jmetrics
from lpr_tpu.eval import plots as jplots
from lpr_tpu.models import cyclegan as jgan
from lpr_tpu.models import lpsr as jlpsr
from lpr_tpu.models import yolo as jyolo
from lpr_tpu.pipeline import chars as jchars
from lpr_tpu.weights import export_torch as jexport
from lpr_tpu.weights import torch_ckpt as jckpt
from lpr_tpu_torch import imageio
from lpr_tpu_torch.eval import harness as tharness
from lpr_tpu_torch.eval import metrics as tmetrics
from lpr_tpu_torch.eval import plots as tplots
from lpr_tpu_torch.models import cyclegan as tgan
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.pipeline import chars as tchars
from lpr_tpu_torch.weights import torch_ckpt as tckpt
from lpr_tpu_torch.weights.checkpoint import params_from_jax

from .torch_ref import CHAR, LPSR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOLDERS = ["real_plates", "real_plates2", "real_plates_cn"]
BATCH = 8          # 20 images: the last batch is padded


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread: the suite runs several test
    processes at once, and there PyTorch's thread pool, waiting for busy
    cores, made these tests up to 25x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _npz_params(path, init):
    """``lpr_tpu.weights.checkpoint.load_params`` of an npz into the
    structure ``init`` builds, without running ``init`` (jitted, it
    compiles for ~15 s a model on the CPU): each leaf the npz entry at its
    key path, as float32."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    with np.load(path) as data:
        return jax.tree_util.tree_map_with_path(
            lambda p, sd: np.asarray(data["/".join(
                str(getattr(k, "key", getattr(k, "idx", k))) for k in p)]
            ).astype(sd.dtype), shapes)


def _jax_lpsr():
    cfg = jlpsr.LPSRConfig()
    return _npz_params(LPSR, lambda k: jlpsr.lpsr_init(k, cfg))


# ---- metrics -------------------------------------------------------------

def _boxes(rng, n):
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _detections(seed, n_img=6, nc=4):
    """Per image: predicted boxes near the ground truth and stray ones,
    their confidences and classes, and the ground truth."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_img):
        n_gt = rng.randint(0, 6)
        gt = _boxes(rng, n_gt)
        gt_cls = rng.randint(0, nc, n_gt)
        near = gt + rng.normal(0, 2, gt.shape).astype(np.float32)
        stray = _boxes(rng, rng.randint(0, 4))
        pred = np.concatenate([near, stray]) if len(near) else stray
        cls = np.concatenate([np.where(rng.rand(n_gt) < 0.8, gt_cls,
                                       rng.randint(0, nc, n_gt)),
                              rng.randint(0, nc, len(stray))]).astype(int)
        conf = rng.rand(len(pred)).astype(np.float32)
        out.append((pred, conf, cls, gt, gt_cls))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_metrics_equal_jax(seed):
    dets = _detections(seed)
    rng = np.random.RandomState(seed)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    np.testing.assert_array_equal(tmetrics.box_iou_np(a, b),
                                  jmetrics.box_iou_np(a, b))
    te, je = tmetrics.DetectionEvaluator(), jmetrics.DetectionEvaluator()
    tc, jc = tmetrics.ConfusionMatrix(4), jmetrics.ConfusionMatrix(4)
    for pred, conf, cls, gt, gt_cls in dets:
        np.testing.assert_array_equal(
            tmetrics.match_predictions(pred, cls, gt, gt_cls, te.IOUS),
            jmetrics.match_predictions(pred, cls, gt, gt_cls, je.IOUS))
        te.add(pred, conf, cls, gt, gt_cls)
        je.add(pred, conf, cls, gt, gt_cls)
        tc.process_batch(pred, conf, cls, gt, gt_cls)
        jc.process_batch(pred, conf, cls, gt, gt_cls)
    got, ref = te.compute(), je.compute()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
    np.testing.assert_array_equal(tc.matrix, jc.matrix)
    r = np.sort(rng.rand(20))
    p = rng.rand(20)
    assert tmetrics.compute_ap(r, p) == jmetrics.compute_ap(r, p)


def test_levenshtein_and_cer_equal_jax():
    rng = random.Random(0)
    alphabet = "0123456789ABCDEFGH"
    for _ in range(300):
        a = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 9)))
        b = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 9)))
        assert tharness.levenshtein(a, b) == jharness.levenshtein(a, b)
        assert tharness.cer(a, b) == jharness.cer(a, b)


def test_detections_to_string_conf_equals_jax():
    rng = np.random.RandomState(3)
    for n_valid in (0, 1, 5, 9):
        boxes = _boxes(rng, 12)
        classes = rng.randint(0, 36, 12)
        scores = rng.rand(12).astype(np.float32)
        valid = np.zeros(12, bool)
        valid[rng.permutation(12)[:n_valid]] = True
        assert (tchars.detections_to_string_conf(boxes, classes, scores,
                                                 valid)
                == jchars.detections_to_string_conf(boxes, classes, scores,
                                                    valid))


def test_plots_draw_or_return_none(tmp_path, monkeypatch):
    """With matplotlib each plot is a figure written to its path, as the
    JAX module's; without it each returns None and writes nothing."""
    grid = np.linspace(0, 1, 11)
    labels = np.random.RandomState(0).rand(30, 5)
    labels[:, 0] = np.floor(labels[:, 0] * 4)
    calls = [
        lambda m, p: m.plot_pr_curve(grid, {"a": grid[::-1]}, p),
        lambda m, p: m.plot_confusion_matrix(np.eye(3), ["a", "b"], p),
        lambda m, p: m.plot_labels(labels, p)]
    import matplotlib.pyplot as plt

    for i, call in enumerate(calls):
        for mod in (tplots, jplots):
            if i == 0:      # writing a figure costs seconds; one each
                path = tmp_path / f"{mod.__name__}.png"
                assert call(mod, str(path)) is not None
                assert path.stat().st_size > 0
            else:
                fig = call(mod, None)
                assert fig is not None
                plt.close(fig)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for i, call in enumerate(calls):
        assert call(tplots, str(tmp_path / f"none_{i}.png")) is None
        assert not (tmp_path / f"none_{i}.png").exists()


# ---- the evaluator -------------------------------------------------------

def _rendered_plates():
    """4 plates rendered as the char OCR's training data (clean one-row,
    degraded one-row, two-row): the synthetic-trained OCR reads them."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from synth_plates import degrade, random_plate_text, render_plate

    rng = random.Random(0)
    images, gts = [], []
    for i in range(4):
        two = i == 3
        text = random_plate_text(rng, two)
        img = render_plate(text, two_row=two)
        images.append(degrade(img, seed=i) if i == 2 else img)
        gts.append(text.upper())
    return images, gts


@pytest.fixture(scope="module")
def eval_data():
    """(group of each image, images, ground truths): the three fixture
    folders, then the rendered plates."""
    groups, images, gts = [], [], []
    for folder in FOLDERS:
        path = os.path.join(ROOT, "tests", "fixtures", folder)
        for f in imageio.list_images(path):
            groups.append(folder)
            images.append(imageio.read_rgb(os.path.join(path, f)))
            gts.append(os.path.splitext(f)[0].upper())
    r_images, r_gts = _rendered_plates()
    return (groups + ["rendered"] * len(r_images), images + r_images,
            gts + r_gts)


@pytest.fixture(scope="module")
def evaluators():
    """(JAX evaluator, the port's on the CPU), the same weights, float32;
    the JAX one is compiled once for the module."""
    anchors = np.asarray(np.load(CHAR)["__anchors__"], np.float32)
    cm = jyolo.build_yolo(jyolo.char_ocr_spec(), ckpt_anchors=anchors,
                          strides=(8,))
    jev = jharness.OcrEvaluator(cm, _npz_params(CHAR, cm.init), _jax_lpsr(),
                                names=list(jchars.OCR_CLASSES))
    char, _, ck = tyolo.load_char_ocr_npz(CHAR, device="cpu")
    tnames = ck.names
    tev = tharness.OcrEvaluator(char, tlpsr.load_lpsr(LPSR, device="cpu"),
                                names=tnames, device="cpu")
    return jev, tev


@pytest.fixture(scope="module")
def reports(evaluators, eval_data):
    jev, tev = evaluators
    _, images, gts = eval_data
    return (jev.evaluate_arrays(images, gts, batch_size=BATCH),
            tev.evaluate_arrays(images, gts, batch_size=BATCH))


def test_prep_host_equals_jax_exactly(evaluators, eval_data):
    """The OCR canvas (Pillow bilinear fit, centred) and the SR input
    (Pillow bicubic) are the JAX evaluator's, bit for bit."""
    jev, tev = evaluators
    for img in eval_data[1]:
        for got, ref in zip(tev._prep_host(img), jev._prep_host(img)):
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("group", FOLDERS + ["rendered"])
def test_evaluator_strings_match_jax(group, reports, eval_data):
    """Per image: the raw and SR strings identical, their mean
    confidences within 1e-3."""
    jrep, trep = reports
    rows = [i for i, g in enumerate(eval_data[0]) if g == group]
    assert rows
    for i in rows:
        j, t = jrep.per_image[i], trep.per_image[i]
        assert set(t) == set(j)
        assert (t["gt"], t["raw"], t["sr"], t["index"]) == (
            j["gt"], j["raw"], j["sr"], j["index"])
        assert abs(t["raw_conf"] - j["raw_conf"]) < 1e-3
        assert abs(t["sr_conf"] - j["sr_conf"]) < 1e-3


def test_evaluator_scores_match_jax(reports, eval_data):
    """acc/CER raw and SR equal; the rendered plates read non-empty."""
    jrep, trep = reports
    assert trep.n == jrep.n == len(eval_data[1])
    for k in ("acc_raw", "acc_sr", "cer_raw", "cer_sr"):
        assert getattr(trep, k) == getattr(jrep, k), k
    assert trep.summary() == jrep.summary()
    rendered = [r for r, g in zip(trep.per_image, eval_data[0])
                if g == "rendered"]
    assert all(r["raw"] for r in rendered)
    assert sum(r["raw"] == r["gt"] for r in rendered) >= 1


def test_evaluate_folder_matches_evaluate_arrays(evaluators, reports):
    """evaluate_folder reads the folder in sorted order with the stem as
    ground truth, as the first rows of the report."""
    _, tev = evaluators
    rep = tev.evaluate_folder(os.path.join(ROOT, "tests", "fixtures",
                                           FOLDERS[1]), batch_size=BATCH)
    first = len(imageio.list_images(os.path.join(ROOT, "tests", "fixtures",
                                                 FOLDERS[0])))
    want = reports[1].per_image[first:first + rep.n]
    assert [(r["gt"], r["raw"], r["sr"]) for r in rep.per_image] == [
        (r["gt"], r["raw"], r["sr"]) for r in want]


def test_evaluator_refuses_a_foreign_lpsr_config():
    char, _, _ = tyolo.load_char_ocr_npz(CHAR, device="cpu")
    sr = tlpsr.load_lpsr(LPSR, device="cpu")
    with pytest.raises(ValueError, match="lpsr_cfg"):
        tharness.OcrEvaluator(char, sr, tlpsr.LPSRConfig(num_blocks=2),
                              device="cpu")


# ---- .pth import ---------------------------------------------------------

def test_lpsr_pth_loads_in_both_packages(tmp_path):
    """A .pth written by the JAX package's export (the reference's
    158-tensor layout, dead RDBs and CSAR copies included): the port's
    load_lpsr(.pth) gives its load_lpsr(.npz)'s outputs to 1e-6, and the
    JAX load_lpsr(.pth) gives the same."""
    path = str(tmp_path / "best_model.pth")
    jexport.save_lpsr_torch(path, _jax_lpsr())
    sd = tckpt.load_state_dict(path)
    assert len(sd) == 158
    state = tlpsr.lpsr_from_torch(sd)
    ref_state = params_from_jax(jax.device_get(jlpsr.lpsr_from_torch(sd)))
    assert sorted(state) == sorted(ref_state)
    for k in state:
        np.testing.assert_array_equal(state[k], ref_state[k])
    x = np.random.RandomState(0).rand(2, 16, 64, 3).astype(np.float32)
    with torch.inference_mode():
        got = tlpsr.load_lpsr(path, device="cpu")(torch.from_numpy(x))
        want = tlpsr.load_lpsr(LPSR, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    jout = jax.jit(lambda p, x: jlpsr.lpsr_apply(p, x, jlpsr.LPSRConfig()))(
        jlpsr.load_lpsr(path), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)


def _generator_sd(seed):
    """A reference-named CycleGAN Generator state dict (``model.{i}``)
    of small random weights, as torch tensors."""
    shapes = jax.eval_shape(jgan.generator_init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    sd = {}

    def put(name, p):
        w = p["w"].shape[::-1]
        sd[f"{name}.weight"] = torch.from_numpy(
            (rng.randn(*w) * 0.05).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(
            (rng.randn(w[0]) * 0.05).astype(np.float32))

    for key, i in (("head", 1), ("down0", 4), ("down1", 7), ("up0", 20),
                   ("up1", 23), ("tail", 26)):
        put(f"model.{i}", shapes[key])
    for j, i in enumerate(range(10, 19)):
        put(f"model.{i}.conv_block.1", shapes["blocks"][j]["c0"])
        put(f"model.{i}.conv_block.5", shapes["blocks"][j]["c1"])
    return sd


def test_cyclegan_pth_loads_in_both_packages(tmp_path):
    """A Generator state dict saved with torch.save, wrapped as the
    reference trainers wrap it: the port's load_generator(.pth) and the
    JAX generator_from_torch(load_state_dict(.pth)) agree within 1e-4."""
    path = str(tmp_path / "G.pth")
    torch.save({"model_state_dict": _generator_sd(1), "epoch": 3}, path)
    gen = tgan.load_generator(path, device="cpu")
    jp = jgan.generator_from_torch(jckpt.load_state_dict(path))
    x = np.random.RandomState(2).uniform(-1, 1, (1, 32, 32, 3)
                                         ).astype(np.float32)
    with torch.inference_mode():
        got = tgan.generator_apply(gen, torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jgan.generator_apply)(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_load_state_dict_refuses_a_pickled_module(tmp_path):
    """A pickled module is not a state dict: the port's restricted reader
    (the JAX reader's) refuses it as the JAX load_state_dict does, and so
    does load_lpsr; a dict holding more than tensors too.  An .onnx LPSR
    (the port's emit of the npz) loads, equal to the npz model."""
    from lpr_tpu_torch.weights.onnx_export import export_lpsr_onnx

    path = str(tmp_path / "module.pt")
    torch.save(torch.nn.Linear(2, 2), path)
    with pytest.raises(ValueError, match="not a plain state-dict"):
        jckpt.load_state_dict(path)
    with pytest.raises(ValueError, match="not a plain state-dict"):
        tckpt.load_state_dict(path)
    with pytest.raises(ValueError, match="not a plain state-dict"):
        tlpsr.load_lpsr(path, device="cpu")
    torch.save({"a": torch.ones(2), "b": 3}, path)
    with pytest.raises(ValueError, match="plain state-dict"):
        tckpt.load_state_dict(path)
    onnx = str(tmp_path / "m.onnx")
    export_lpsr_onnx(tlpsr.lpsr_state(LPSR), onnx)
    got = dict(tlpsr.load_lpsr(onnx, device="cpu").named_buffers())
    want = dict(tlpsr.load_lpsr(LPSR, device="cpu").named_buffers())
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---- on the card ---------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_evaluator_on_card_matches_cpu():
    """The evaluator on the card (float32, K2's float32 instance) reads the
    raw strings the CPU reads, and at most one SR string a folder
    differently (the fixture folders: the card's machine has no TrueType
    font to render plates with)."""
    _need_card()
    from lpr_tpu_torch.kernels.lpsr import lpsr_fused

    groups, images, gts = [], [], []
    for folder in FOLDERS:
        path = os.path.join(ROOT, "tests", "fixtures", folder)
        for f in imageio.list_images(path):
            groups.append(folder)
            images.append(imageio.read_rgb(os.path.join(path, f)))
            gts.append(os.path.splitext(f)[0].upper())
    reps = {}
    for dev in ("cuda", "cpu"):
        char, _, ck = tyolo.load_char_ocr_npz(CHAR, device=dev)
        names = ck.names
        ev = tharness.OcrEvaluator(char, tlpsr.load_lpsr(LPSR, device=dev),
                                   names=names, device=dev)
        before = lpsr_fused.launches
        reps[dev] = ev.evaluate_arrays(images, gts, batch_size=BATCH)
        if dev == "cuda":
            assert lpsr_fused.launches - before == -(-len(images) // BATCH)
    for group in set(groups):
        rows = [i for i, g in enumerate(groups) if g == group]
        card = [reps["cuda"].per_image[i] for i in rows]
        cpu = [reps["cpu"].per_image[i] for i in rows]
        assert [r["raw"] for r in card] == [r["raw"] for r in cpu]
        assert sum(a["sr"] != b["sr"] for a, b in zip(card, cpu)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 1])
def test_k2_float32_matches_plain_at_the_evaluator_shapes(n, monkeypatch):
    """K2's float32 instance against lpsr_plain within the float32 TOL_*,
    the plain version's convolutions in full float32 (TF32 off)."""
    _need_card()
    from lpr_tpu_torch.kernels import lpsr as kl

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    packed = kl.lpsr_pack(tlpsr.load_lpsr(LPSR, device="cuda"))
    x = torch.rand((n, 32, 192, 3), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(n))
    got, ref = kl.lpsr_fused(x, packed), kl.lpsr_plain(x, packed)
    max_err, mean_err = kl.lpsr_errors(got, ref)
    assert max_err < kl.TOL_MAX[torch.float32]
    assert mean_err < kl.TOL_MEAN[torch.float32]
