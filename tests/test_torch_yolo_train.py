"""The port's detector training route and trainer against the JAX package's,
on the CPU: ``train_forward`` against ``YoloModel.apply(train=True)`` for
``tests/test_yolo_train.py``'s tiny spec, yolov5 at width 0.125 with the
S2D stem, a narrow char OCR spec with C3TR and every other builder module;
``YoloTrainer.step`` (plain, ``accumulate=2``, past warm-up, a non-finite
batch) against the JAX trainer's; ``validate_map`` on
``checkpoints/plate_det640.npz``; ``fit_yolo``'s checkpoints in JAX's
``load_params``.  The same flat state goes to both sides (the port's
``yolo_init``, placed into JAX's pytree by ``tests/train_ref.py``); JAX
convolutions at 'highest'.

Tolerances:
- the running statistics within 1e-5 of their largest magnitude;
- the raws: the port in float64 is the reference; JAX's float32 within
  1e-4 of the largest |raw| from it (the same function), and the port's
  float32 within twice JAX's own distance from it plus 1e-6.  Batch
  statistics over a 2x2 map of two images amplify float32 rounding to a
  few 1e-5 on both sides alike, so a fixed 1e-5 between the two float32
  results does not hold at these sizes; for the tiny spec it does;
- one trainer step: the trainer's own gradient (``YoloTrainer.grads``,
  the sum over the micro-batches) in norm within 1e-3 of the port's
  float64 gradient of the same micro-batches, plus 1e-6 of the largest
  gradient (the float32 noise of a gradient that cancels to ~0);
  parameters within 1e-6 plus the SGD move of the gradient difference,
  lr * (1 + momentum) * |g_port - g_jax|; momenta within 1e-6 plus
  |g_port - g_jax| (plus the weight decay's share); EMA within 1e-6
  plus its share (1 - d) of the parameters' bound; running statistics
  within 1e-5.  A pre-activation that rounds to exactly 0 on one side
  only meets the SiLU's flush there (a gradient of 0 where the other side
  has one), which is why the steps are held to the gradient difference
  and the gradients separately, in norm, to the float64 ones;
- validate_map's mAP50 and mAP within 1e-6 of JAX's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.models import yolo as jy
from lpr_tpu.train import yolo as jt
from lpr_tpu.train.yolo_loss import yolo_loss as j_loss
from lpr_tpu_torch.models import yolo as ty
from lpr_tpu_torch.models.yolo_train import train_forward, yolo_init
from lpr_tpu_torch.train import yolo as tt
from lpr_tpu_torch.train.yolo_loss import yolo_loss as t_loss
from lpr_tpu_torch.weights.checkpoint import params_from_jax

from .test_torch_zoo import MODULE_ROWS, _module_spec
from .test_yolo_train import tiny_spec
from .train_ref import jax_tree, one_torch_thread  # noqa: F401

PLATE = "checkpoints/plate_det640.npz"
HW = (64, 64)


def _t_spec(js):
    return ty.YoloSpec(js.nc, js.depth_multiple, js.width_multiple,
                       js.anchors, tuple(js.backbone), tuple(js.head), js.ch)


def _specs():
    ocr = jy.char_ocr_spec()
    return {
        "tiny": (tiny_spec(), (8,)),
        "yolov5_w0.125": (jy.yolov5_spec(nc=3, depth=0.33, width=0.125),
                          (8, 16, 32)),
        "char_ocr_narrow": (jy.YoloSpec(5, ocr.depth_multiple, 0.125,
                                        ocr.anchors, ocr.backbone,
                                        ocr.head), (8,)),
    }


def _randomized(flat, seed):
    """Batch norm away from its init (1, 0, 0, 1), so that scale and
    shift are exercised."""
    rng = np.random.RandomState(seed)
    out = dict(flat)
    for k, v in flat.items():
        if k.endswith(("bn/gamma", "bn/var")):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(("bn/beta", "bn/mean")):
            out[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
    return out


def _pair(js, strides, seed=0):
    jm = jy.build_yolo(js, strides=strides)
    tm = ty.build_yolo(_t_spec(js), strides=strides)
    flat = _randomized(yolo_init(tm, torch.Generator().manual_seed(seed)),
                       seed)
    return jm, tm, flat


def _tensors(flat, dtype=torch.float32, grad=False):
    return {k: torch.from_numpy(v).to(dtype).requires_grad_(grad)
            for k, v in flat.items()}


@pytest.fixture(scope="module")
def forwards():
    """Per spec: the JAX raws and new state, the port's float32 and
    float64 raws and statistics, on one batch of 2 at 64x64."""
    x = np.random.RandomState(5).rand(2, *HW, 3).astype(np.float32)
    out = {}
    for name, (js, strides) in _specs().items():
        jm, tm, flat = _pair(js, strides)
        jp = jax_tree(jm.init, flat)
        raws, new = jax.jit(lambda p, v: jm.apply(p, v, decode=False,
                                                  train=True))(jp, x)
        r32, s32 = train_forward(tm, _tensors(flat), torch.from_numpy(x))
        r64, _ = train_forward(tm, _tensors(flat, torch.float64),
                               torch.from_numpy(x).double())
        out[name] = ([np.asarray(r) for r in raws],
                     params_from_jax(jax.device_get(new)), r32, s32, r64)
    return out


@pytest.mark.parametrize("name", list(_specs()))
def test_train_forward_matches_jax(forwards, name):
    j_raws, j_new, r32, s32, r64 = forwards[name]
    for a, b, c in zip(j_raws, r32, r64):
        c = c.numpy()
        m = np.abs(c).max()
        j_err = np.abs(a - c).max() / m
        t_err = np.abs(b.double().numpy() - c).max() / m
        assert j_err < 1e-4, (name, j_err)
        assert t_err <= 2 * j_err + 1e-6, (name, t_err, j_err)
        if name == "tiny":
            assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(a).max()
    stat_keys = {k for k in j_new if k.endswith(("/mean", "/var"))}
    assert set(s32) == stat_keys
    for k, v in s32.items():
        assert np.abs(j_new[k] - v.numpy()).max() <= (
            1e-5 * max(np.abs(j_new[k]).max(), 1.0)), k


@pytest.mark.parametrize("name", sorted(MODULE_ROWS))
def test_every_module_kind_trains_as_jax(name):
    """Each builder module in training mode (Focus, DWConv, Bottleneck,
    BottleneckCSP with its standalone batch norm on running statistics,
    C3SPP, C3Ghost, GhostConv, GhostBottleneck s1/s2, Contract, Expand)
    at (2, 32, 48): raws within 1e-4 of the largest, running statistics
    within 1e-5, the same statistics keys."""
    js, strides = _module_spec(name)
    jm, tm, flat = _pair(js, strides, seed=1)
    x = np.random.RandomState(2).rand(2, 32, 48, 3).astype(np.float32)
    raws, new = jax.jit(lambda p, v: jm.apply(p, v, decode=False,
                                              train=True))(
        jax_tree(jm.init, flat), x)
    got, stats = train_forward(tm, _tensors(flat), torch.from_numpy(x))
    for a, b in zip(raws, got):
        a = np.asarray(a)
        assert np.abs(a - b.detach().numpy()).max() <= 1e-4 * np.abs(a).max()
    new = params_from_jax(jax.device_get(new))
    changed = {k for k in new if k.endswith(("/mean", "/var"))
               and not np.array_equal(new[k], flat[k])}
    assert set(stats) == changed
    for k, v in stats.items():
        assert np.abs(new[k] - v.numpy()).max() <= 1e-5 * max(
            np.abs(new[k]).max(), 1.0), k


def _grads(tm, flat, x, lab, dtype):
    p = _tensors(flat, dtype, grad=True)
    raws, _ = train_forward(tm, p, torch.from_numpy(x).to(dtype))
    total, _ = t_loss(raws, torch.from_numpy(lab),
                      torch.from_numpy(np.asarray(tm.anchors)))
    keys = list(p)
    g = torch.autograd.grad(total, [p[k] for k in keys], allow_unused=True)
    return {k: (torch.zeros_like(p[k]) if v is None else v).double().numpy()
            for k, v in zip(keys, g)}


def _labels(B, T=3):
    lab = np.zeros((B, T, 5), np.float32)
    lab[:, 0] = [1, 0.5, 0.5, 0.3, 0.3]
    lab[:, 1] = [2, 0.25, 0.3, 0.2, 0.1]
    lab[::2, 2] = [0, 0.7, 0.75, 0.4, 0.2]
    return lab


@pytest.mark.parametrize("name", ["yolov5_w0.125", "char_ocr_narrow"])
def test_gradients_reach_every_leaf_as_in_jax(name):
    """Through the S2D stem's 6x6 weight and C3TR's attention: the port's
    float64 gradients against JAX's float32 ones, each tensor within 1e-3
    of the reference's norm; every leaf JAX moves, the port moves."""
    js, strides = _specs()[name]
    jm, tm, flat = _pair(js, strides, seed=2)
    x = np.random.RandomState(3).rand(2, *HW, 3).astype(np.float32)
    lab = _labels(2)

    def f(p):
        raws, _ = jm.apply(p, x, decode=False, train=True)
        return j_loss(raws, jnp.asarray(lab), jnp.asarray(jm.anchors))[0]

    gj = params_from_jax(jax.device_get(
        jax.jit(jax.grad(f))(jax_tree(jm.init, flat))))
    g64 = _grads(tm, flat, x, lab, torch.float64)
    assert set(gj) == set(g64)
    # a tensor whose true gradient is ~0 (a bias before a batch norm
    # cancels) carries float32 noise: a floor of 1e-6 of the largest
    floor = 1e-6 * max(np.abs(g).max() for g in g64.values())
    for k, ref in g64.items():
        n = np.linalg.norm(ref)
        if n == 0:
            assert not np.any(gj[k]), k
            continue
        assert np.linalg.norm(gj[k] - ref) <= 1e-3 * n + floor, k
    key = "0/w" if name.startswith("yolov5") else "9/m/tr/0/q"
    assert np.linalg.norm(g64[key]) > 0


def _check_step(tm, flat, x, lab, js_state, t_state, t_trainer, step0,
                grads=None):
    """One step's state on both sides within the bounds of the module
    docstring, given each side's gradients (JAX's from value_and_grad),
    and the trainer's gradient against the float64 one of its
    micro-batches.  ``grads``: the port's gradient of the step where it
    was not this trainer's (numpy, by key), else ``t_trainer.grads``."""
    lr_w, lr_b, mom = t_trainer.rates(step0)
    wd = t_trainer.cfg.weight_decay
    d = t_trainer.cfg.ema_decay * (1 - np.exp(-(step0 + 1)
                                              / t_trainer.cfg.ema_tau))
    if grads is None:
        g_t, _, _, _ = t_trainer.grads(
            tt.YoloTrainer.init(t_trainer, params=flat)["params"],
            torch.from_numpy(x), torch.from_numpy(lab))
    else:
        g_t = {k: torch.from_numpy(v) for k, v in grads.items()}
    acc = t_trainer.accumulate
    g64 = [_grads(tm, flat, xi, li, torch.float64)
           for xi, li in zip(np.split(x, acc), np.split(lab, acc))]
    g64 = {k: sum(g[k] for g in g64) for k in g_t}
    floor = 1e-6 * max(np.abs(g).max() for g in g64.values())
    for k, ref in g64.items():
        err = np.linalg.norm(g_t[k].double().numpy() - ref)
        assert err <= 1e-3 * np.linalg.norm(ref) + floor, k
    ref = {part: params_from_jax(jax.device_get(js_state[part]))
           for part in ("params", "momenta", "ema")}
    for k in ref["params"]:
        got_p = t_state["params"][k].detach().numpy()
        if tt._is_running_stat(k):
            assert k not in g_t and k not in t_state["momenta"], k
            assert np.abs(got_p - ref["params"][k]).max() <= 1e-5 * max(
                np.abs(ref["params"][k]).max(), 1.0), k
            continue
        dg = np.abs(g_t[k].numpy() - js_state["_grads"][k])
        lr = lr_b if tt._is_bias(k) else lr_w
        p_tol = 1e-6 + lr * (1 + mom) * dg
        assert np.all(np.abs(got_p - ref["params"][k]) <= p_tol), k
        m_tol = 1e-6 + dg * (1 + wd)
        assert np.all(np.abs(t_state["momenta"][k].numpy()
                             - ref["momenta"][k]) <= m_tol), k
        assert np.all(np.abs(t_state["ema"][k].numpy() - ref["ema"][k])
                      <= 1e-6 + (1 - d) * p_tol), k


@pytest.fixture(scope="module")
def tiny_jax():
    """The tiny spec's pair, JAX trainers with accumulate 1 and 2 and
    JAX's jitted gradient, built once for the step tests (each JAX step
    compiles once a trainer)."""
    js, strides = _specs()["tiny"]
    jm, tm, flat = _pair(js, strides, seed=3)

    def f(p, xi, li):
        raws, _ = jm.apply(p, xi, decode=False, train=True)
        return j_loss(raws, li, jnp.asarray(jm.anchors))[0]

    trainers = {acc: jt.YoloTrainer(jm, jt.YoloTrainConfig(),
                                    steps_per_epoch=10, accumulate=acc)
                for acc in (1, 2)}
    return jm, tm, flat, trainers, jax.jit(jax.grad(f))


def _jax_grads(grad_fn, params, x, lab, acc):
    """JAX's summed gradient of the step (running statistics do not touch
    the outputs in training, so the micro-batches' order is free)."""
    g = None
    for xi, li in zip(np.split(x, acc), np.split(lab, acc)):
        gi = grad_fn(params, xi, jnp.asarray(li))
        g = gi if g is None else jax.tree.map(jnp.add, g, gi)
    return params_from_jax(jax.device_get(g))


@pytest.mark.parametrize("acc,step0", [(1, 0), (2, 0), (1, 1000)])
def test_trainer_step_matches_jax(tiny_jax, acc, step0):
    """One step of the tiny spec at batch 4 from the same state: at step 0
    (warm-up: weights' lr 0, biases' lr 0.1, momentum 0.8), with
    ``accumulate=2`` (where a batch of 3 does not split and raises, as
    JAX's reshape does), and past warm-up (step 1000 of 10 a epoch)."""
    jm, tm, flat, trainers, grad_fn = tiny_jax
    x = np.random.RandomState(4).rand(4, *HW, 3).astype(np.float32)
    lab = _labels(4)
    jtr = trainers[acc]
    jstate = jtr.init(params=jax_tree(jm.init, flat))
    jstate["step"] = jnp.int32(step0)
    grads = _jax_grads(grad_fn, jstate["params"], x, lab, acc)
    jstate, jtot, _ = jtr.step(jstate, jnp.asarray(x), jnp.asarray(lab))
    jstate["_grads"] = grads
    ttr = tt.YoloTrainer(tm, tt.YoloTrainConfig(), steps_per_epoch=10,
                         accumulate=acc, device="cpu")
    tstate = ttr.init(params=flat)
    tstate["step"] = step0
    if acc > 1:
        with pytest.raises(ValueError, match="does not split"):
            ttr.step(tstate, x[:3], lab[:3])
    tstate, ttot, comps = ttr.step(tstate, x, lab)
    assert tstate["step"] == step0 + 1
    assert abs(float(ttot) - float(jtot)) <= 1e-5 * abs(float(jtot))
    _check_step(tm, flat, x, lab, jstate, tstate, ttr, step0)
    if step0 == 0:   # weights do not move in the first warm-up step
        for k in ("0/w", "2/cv1/w"):
            np.testing.assert_array_equal(
                tstate["params"][k].detach().numpy(), flat[k])


def test_warmup_rates_match_jax_per_group():
    """The port's (weight lr, bias lr, momentum) at steps 0, 50 and past
    warm-up, linear and cosine, against the JAX step's formulas."""
    for cos in (False, True):
        cfg = tt.YoloTrainConfig(cos_lr=cos, epochs=30)
        tr = tt.YoloTrainer(ty.build_yolo(_t_spec(tiny_spec()),
                                          strides=(8,)), cfg,
                            steps_per_epoch=10, device="cpu")
        jc = jt.YoloTrainConfig(cos_lr=cos, epochs=30)
        for step in (0, 50, 100, 250):
            base = jc.lr0 * float(jt.lr_schedule(jc, jnp.float32(step / 10)))
            wprog = min(step / 100, 1.0)
            lr_b = base if wprog >= 1 else (
                jc.warmup_bias_lr + (base - jc.warmup_bias_lr) * wprog)
            mom = jc.warmup_momentum + (jc.momentum - jc.warmup_momentum
                                        ) * wprog
            got = tr.rates(step)
            np.testing.assert_allclose(got, (base * wprog, lr_b, mom),
                                       rtol=1e-6)
    keys = {"3/cv1/w": (True, False), "3/cv1/bn/beta": (False, True),
            "3/cv1/bn/gamma": (False, False), "24/m/0/b": (False, True),
            "9/m/linear/w": (True, False), "9/m/tr/0/q": (False, False)}
    for k, (decay, bias) in keys.items():
        assert (tt._is_conv_weight(k), tt._is_bias(k)) == (decay, bias), k


def test_non_finite_batch_changes_nothing_but_the_step():
    js, strides = _specs()["tiny"]
    _, tm, flat = _pair(js, strides, seed=4)
    ttr = tt.YoloTrainer(tm, tt.YoloTrainConfig(), steps_per_epoch=10,
                         device="cpu")
    st = ttr.init(params=flat)
    x = np.random.RandomState(6).rand(2, *HW, 3).astype(np.float32)
    st, _, _ = ttr.step(st, x, _labels(2))          # momenta non-zero
    before = {part: {k: v.detach().clone() for k, v in st[part].items()}
              for part in ("params", "momenta", "ema")}
    x[0, 3, 4, 1] = np.nan
    st, total, _ = ttr.step(st, x, _labels(2))
    assert not np.isfinite(float(total)) and st["step"] == 2
    for part, ref in before.items():
        for k, v in ref.items():
            assert torch.equal(st[part][k].detach(), v), (part, k)


def _val_batches():
    """Two batches of two 128x128 crops of the demo frame, with labels
    where the detector fires (and one image without), so mAP is not 0."""
    from lpr_tpu_torch.imageio import read_rgb
    from lpr_tpu_torch.native import resize_pil_bilinear

    frame = read_rgb("tests/fixtures/real_frames/demo_frame.png")
    imgs = np.stack([resize_pil_bilinear(frame, (128, 128)),
                     resize_pil_bilinear(frame[100:400, 200:700], (128, 128)),
                     resize_pil_bilinear(frame[::-1], (128, 128)),
                     np.full((128, 128, 3), 114, np.uint8)])
    return imgs.astype(np.float32) / 255.0


def test_validate_map_matches_jax_on_the_plate_checkpoint():
    from lpr_tpu_torch.weights.checkpoint import load_state

    state, _ = load_state(PLATE)
    tm = ty.yolov5("s", nc=11)
    x = _val_batches()
    # ground truth: the port's own confident detections, moved a little,
    # in two classes, so that the mAP over IoU thresholds is graded
    with torch.no_grad():
        pred, _ = tm.load_state(state).eval()(torch.from_numpy(x),
                                               decode=True)
    from lpr_tpu_torch.ops.nms import nms_batched

    det = nms_batched(pred, 0.05, 0.5, max_det=8, agnostic=False)
    labels = np.zeros((4, 8, 5), np.float32)
    for i in range(4):
        n = min(int(det["count"][i]), 3)
        for j in range(n):
            x1, y1, x2, y2 = det["boxes"][i, j].numpy() / 128.0
            labels[i, j] = [j % 2, (x1 + x2) / 2 + 0.01 * j,
                            (y1 + y2) / 2, (x2 - x1) * 1.1, (y2 - y1)]
    batches = [(x[:2], labels[:2]), (x[2:], labels[2:], 1)]
    got = tt.validate_map(tm, state, batches, device="cpu")
    jm = jy.yolov5("s", nc=11)
    from .test_torch_zoo import npz_params

    ref = jt.validate_map(jm, npz_params(PLATE, jm), batches)
    assert got["map50"] > 0
    for k in ("map50", "map"):
        assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])


def test_fit_yolo_checkpoints_load_in_jax(tmp_path):
    from lpr_tpu.weights.checkpoint import load_params

    from lpr_tpu_torch.utils.callbacks import Callbacks

    js, strides = _specs()["tiny"]
    jm, tm, flat = _pair(js, strides, seed=5)
    x = np.random.RandomState(7).rand(4, *HW, 3).astype(np.float32)
    seen = []
    cb = Callbacks()
    cb.register_action("on_fit_epoch_end", "t",
                       lambda e, m: seen.append((e, m["map"])))
    ttr = tt.YoloTrainer(tm, tt.YoloTrainConfig(epochs=2),
                         steps_per_epoch=1, device="cpu")
    state = tt.fit_yolo(ttr, lambda: [(x, _labels(4))],
                        lambda: [(x, _labels(4))], epochs=2,
                        ckpt_dir=str(tmp_path), logger=lambda m: None,
                        callbacks=cb, init_params=flat)
    assert [e for e, _ in seen] == [0, 1] and state["step"] == 2
    assert set(state["summary"]) == {"best_fitness", "final_fitness",
                                     "final_map50", "final_map"}
    for name in ("best.npz", "last.npz"):
        jp = load_params(str(tmp_path / name), jax_tree(jm.init, flat))
        got = params_from_jax(jax.device_get(jp))
        for k, v in state["ema"].items():
            np.testing.assert_array_equal(got[k], v.numpy())
    assert os.path.exists(tmp_path / "best.npz")
