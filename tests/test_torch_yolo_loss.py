"""The port's YOLO loss against the JAX package's, on the CPU: CIoU, the
candidate lattice of ``build_targets_level`` and ``yolo_loss`` with its
gradient, on the same random logits and labels.

Tolerances: CIoU and the loss within 1e-6 relative; the loss's gradient
with respect to each level's logits within 1e-5 of that tensor's largest
magnitude; the lattice exactly (cell indices, masks, classes and target
boxes), pad rows, targets on the grid's edges and two targets in one cell
included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.ops.boxes import bbox_ciou as j_ciou
from lpr_tpu.train import yolo_loss as jl
from lpr_tpu_torch.ops.boxes import bbox_ciou as t_ciou
from lpr_tpu_torch.train import yolo_loss as tl

from .train_ref import one_torch_thread  # noqa: F401


def _labels(rng, B, T, nc):
    lab = np.zeros((B, T, 5), np.float32)       # rows past n are padding
    for i in range(B):
        n = rng.randint(1, T)
        lab[i, :n, 0] = rng.randint(0, nc, n)
        lab[i, :n, 1:3] = rng.uniform(0, 1, (n, 2))
        lab[i, :n, 3:5] = rng.uniform(0.02, 0.5, (n, 2))
    lab[0, :2, 1:5] = [[0.0, 1.0, 0.1, 0.1], [0.999, 0.0001, 0.2, 0.05]]
    lab[1, :2, 1:5] = [[0.5, 0.5, 0.2, 0.2], [0.51, 0.52, 0.1, 0.3]]
    return lab


def test_bbox_ciou_and_its_gradient_match_jax():
    rng = np.random.RandomState(0)
    a = rng.uniform(0.1, 5, (300, 4)).astype(np.float32)
    b = rng.uniform(0.1, 5, (300, 4)).astype(np.float32)
    a[:5] = b[:5]                                   # identical boxes
    a[5:10, :2] = b[5:10, :2] + 20                  # disjoint: iw, ih at 0
    ref, g_ref = jax.value_and_grad(
        lambda p: j_ciou(p, jnp.asarray(b)).sum())(jnp.asarray(a))
    ref = np.asarray(j_ciou(jnp.asarray(a), jnp.asarray(b)))
    pa = torch.from_numpy(a).requires_grad_(True)
    got = t_ciou(pa, torch.from_numpy(b))
    (g,) = torch.autograd.grad(got.sum(), pa)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6)
    # identical boxes give both sides the same NaN gradients
    g_ref, g = np.asarray(g_ref), g.numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(g_ref))
    ok = ~np.isnan(g_ref)
    assert np.abs(g[ok] - g_ref[ok]).max() <= 1e-5 * np.abs(g_ref[ok]).max()


@pytest.mark.parametrize("grid", [(8, 8), (4, 6), (2, 2)])
def test_build_targets_level_is_exact(grid):
    rng = np.random.RandomState(1)
    lab = _labels(rng, 3, 6, 4)
    anchors = rng.uniform(0.5, 4, (3, 2)).astype(np.float32)
    batched = tl.build_targets_level(torch.from_numpy(lab),
                                     torch.from_numpy(anchors), grid, 4.0)
    for i in range(3):
        ref = jl.build_targets_level(jnp.asarray(lab[i]),
                                     jnp.asarray(anchors), grid, 4.0)
        got = tl.build_targets_level(torch.from_numpy(lab[i]),
                                     torch.from_numpy(anchors), grid, 4.0)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)
            np.testing.assert_array_equal(batched[k][i].numpy(),
                                          np.asarray(ref[k]), err_msg=k)
    # a pad row (w == 0) is never a candidate
    assert not batched["mask"][0, :, -1].any()


@pytest.mark.parametrize("nl,nc,smooth", [(1, 1, 0.0), (1, 4, 0.1),
                                          (3, 4, 0.0), (3, 1, 0.1)])
def test_yolo_loss_and_gradient_match_jax(nl, nc, smooth):
    rng = np.random.RandomState(nl * 10 + nc)
    B, T = 3, 6
    lab = _labels(rng, B, T, nc)
    grids = [(8, 8), (4, 4), (2, 2)][:nl]
    raws = [rng.randn(B, 3, h, w, 5 + nc).astype(np.float32)
            for h, w in grids]
    anchors = rng.uniform(0.5, 4, (nl, 3, 2)).astype(np.float32)

    def f(r):
        return jl.yolo_loss(r, jnp.asarray(lab), jnp.asarray(anchors),
                            jl.YoloLossConfig(label_smoothing=smooth))

    (ref, ref_c), g_ref = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(r) for r in raws])
    rt = [torch.from_numpy(r).requires_grad_(True) for r in raws]
    got, comps = tl.yolo_loss(rt, torch.from_numpy(lab),
                              torch.from_numpy(anchors),
                              tl.YoloLossConfig(label_smoothing=smooth))
    g = torch.autograd.grad(got, rt)
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
    for k in ("box", "obj", "cls"):
        assert abs(float(comps[k]) - float(ref_c[k])) <= (
            1e-6 * abs(float(ref_c[k])) + 1e-7), k
    for a, b in zip(g, g_ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_yolo_loss_empty_labels_and_out_of_range_class():
    rng = np.random.RandomState(3)
    raws = [torch.from_numpy(rng.randn(2, 3, 4, 4, 8).astype(np.float32))]
    anchors = torch.ones(1, 3, 2)
    total, comps = tl.yolo_loss(raws, torch.zeros(2, 4, 5), anchors)
    assert float(comps["box"]) == 0.0 and float(comps["cls"]) == 0.0
    assert np.isfinite(float(total))
    # a class index past nc is a zero one-hot, as jax.nn.one_hot gives
    lab = np.zeros((2, 2, 5), np.float32)
    lab[:, 0] = [7, 0.5, 0.5, 0.3, 0.3]
    ref, _ = jl.yolo_loss([jnp.asarray(raws[0].numpy())], jnp.asarray(lab),
                          jnp.ones((1, 3, 2)))
    got, _ = tl.yolo_loss(raws, torch.from_numpy(lab), anchors)
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
