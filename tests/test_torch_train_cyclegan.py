"""The port's CycleGAN trainer against the JAX package's, on the CPU: the
same initial generators (1 ResNet block, base 8) and PatchGANs (the fixed
64-512 widths), made by the port's inits and placed into JAX's pytrees
(``tests/train_ref.py``), one full step on the same 2x32x64 batches.

Tolerances: losses within 1e-5 relative; each gradient (read from both
Adam states) within 1e-5 of its tensor's largest magnitude; the carried
power-iteration vectors u within 1e-5; each weight after the step within 1e-6 absolute (an
Adam first step moves a weight by lr * g / (|g| + eps), about lr = 2e-4).
The exception is a weight whose gradient is rounding noise: its first Adam
step is lr * g / (|g| + eps) of that noise on each side, anywhere in
[-lr, lr].  Such weights are held within 2 lr.  They are the generator
biases that InstanceNorm follows, whose gradient is zero but for rounding
(the norm removes a per-channel constant), and the weights whose JAX
gradient (read from its Adam state, mu / (1 - b1)) is below 1e-5 of its
tensor's largest gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.models import cyclegan as jcg
from lpr_tpu.train import cyclegan as jtrain
from lpr_tpu_torch.models import cyclegan as tcg
from lpr_tpu_torch.train import cyclegan as ttrain
from lpr_tpu_torch.weights.checkpoint import params_from_jax

from .train_ref import jax_tree, one_torch_thread  # noqa: F401

GEN_J = jcg.GeneratorConfig(n_resnet_blocks=1, base=8)
GEN_T = tcg.GeneratorConfig(n_resnet_blocks=1, base=8)
HW = (32, 64)
LR = 2e-4


def _normed_bias(key: str) -> bool:
    """A generator bias that InstanceNorm follows (all but the tail's)."""
    return key.endswith("/b") and not key.startswith("tail/")


def _grads(opt_state, b1=0.5):
    """JAX's step-1 gradients from its Adam state: mu = (1 - b1) * g."""
    return params_from_jax(jax.device_get(opt_state[0].mu)), 1.0 / (1 - b1)


def _check(got, ref, start, grads, prefix="", noise=lambda k: False):
    """Each weight of ``got`` (leaves) against ``ref`` within 1e-6, or 2 lr
    where its gradient is rounding noise (see the module docstring); each
    weight with a real gradient moved from ``start``."""
    mu, scale = grads
    assert ref.keys() == got.keys()
    for k, v in ref.items():
        if k.endswith("/u"):
            continue
        g = np.abs(mu[prefix + k]) * scale
        tol = np.where(noise(k) | (g < 1e-5 * g.max()), 2 * LR, 1e-6)
        d = np.abs(got[k].detach().numpy() - v)
        assert (d <= tol).all(), (k, float(d.max()))
        moved = g >= 1e-5 * g.max()
        if not noise(k):
            assert (v != start[k])[moved].all(), k


@pytest.fixture(scope="module")
def stepped():
    """(JAX state and metrics, port state and metrics, the initial flat
    states) after one step from the same start."""
    g = torch.Generator().manual_seed(0)
    gs = {"ab": tcg.generator_init(g, GEN_T),
          "ba": tcg.generator_init(g, GEN_T)}
    ds = {"a": tcg.discriminator_init(g, 3), "b": tcg.discriminator_init(g, 3)}
    rng = np.random.RandomState(1)
    real_a = (rng.rand(2, *HW, 3) * 2 - 1).astype(np.float32)
    real_b = (rng.rand(2, *HW, 3) * 2 - 1).astype(np.float32)

    jt = jtrain.CycleGANTrainer(jtrain.CycleGANConfig(), GEN_J)
    jg = {k: jax_tree(jcg.generator_init, v, GEN_J) for k, v in gs.items()}
    jd = {k: jax_tree(jcg.discriminator_init, v, 3) for k, v in ds.items()}
    js = {"g": jg, "d": jd, "g_opt": jt.tx.init(jg),
          "da_opt": jt.tx.init(jd["a"]), "db_opt": jt.tx.init(jd["b"])}
    js, jm = jt.step(js, jnp.asarray(real_a), jnp.asarray(real_b))

    tt = ttrain.CycleGANTrainer(ttrain.CycleGANConfig(), GEN_T, device="cpu")
    ts = tt.state_from(gs, ds)
    ts, tm = tt.step(ts, real_a, real_b)
    return js, jm, ts, tm, gs, ds


def test_step_losses_match_jax(stepped):
    _, jm, _, tm, _, _ = stepped
    assert tm.keys() == jm.keys()
    for k in jm:
        assert np.isfinite(tm[k])
        assert tm[k] == pytest.approx(jm[k], rel=1e-5), k


@pytest.mark.parametrize("which", ["ab", "ba"])
def test_step_generator_weights_match_jax(stepped, which):
    js, _, ts, _, gs, _ = stepped
    _check(ts["g"][which], params_from_jax(jax.device_get(js["g"][which])),
           gs[which], _grads(js["g_opt"]), f"{which}/", _normed_bias)


@pytest.mark.parametrize("which", ["a", "b"])
def test_step_discriminator_weights_and_u_match_jax(stepped, which):
    js, _, ts, _, _, ds = stepped
    ref = params_from_jax(jax.device_get(js["d"][which]))
    got = ts["d"][which]
    _check(got, ref, ds[which], _grads(js[f"d{which}_opt"]))
    for k in ref:
        assert got[k].requires_grad == (not k.endswith("/u")), k
        if k.endswith("/u"):
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0,
                                       atol=1e-5, err_msg=k)
            assert not np.array_equal(ref[k], ds[which][k]), k


def _port_grads(opt, tensors):
    """The port's step-1 gradients from its Adam state, as ``_grads``."""
    b1 = opt.defaults["betas"][0]
    return {k: (opt.state[v]["exp_avg"] / (1 - b1)).numpy()
            for k, v in tensors.items() if not k.endswith("/u")}


@pytest.mark.parametrize("which", ["ab", "ba", "a", "b"])
def test_step_gradients_match_jax(stepped, which):
    """Each gradient of the step within 1e-5 of its tensor's largest
    magnitude, as in the LPSR trainer's test; both read from the Adam
    state (the weights above only test the gradients' signs, since a first
    Adam step is about lr * sign(g)).  The generator biases that
    InstanceNorm follows are left out: their true gradient is zero."""
    js, _, ts, _, _, _ = stepped
    if which in ("ab", "ba"):
        opt, prefix, tensors = ts["g_opt"], f"{which}/", ts["g"][which]
        mu, scale = _grads(js["g_opt"])
    else:
        opt, prefix, tensors = ts[f"d{which}_opt"], "", ts["d"][which]
        mu, scale = _grads(js[f"d{which}_opt"])
    got = _port_grads(opt, tensors)
    for k, g in got.items():
        if which in ("ab", "ba") and _normed_bias(k):
            continue
        ref = mu[prefix + k] * scale
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-3),
                                   err_msg=k)


def test_generator_step_reaches_only_the_generators():
    """The G step's gradient goes to the generators alone; the D step's
    fake pass takes detached fakes, so its gradient reaches no generator."""
    tt = ttrain.CycleGANTrainer(ttrain.CycleGANConfig(), GEN_T, device="cpu")
    ts = tt.init(torch.Generator().manual_seed(2))
    x = torch.rand((1, *HW, 3)) * 2 - 1
    loss, aux = tt.g_loss(ts, x, x)
    loss.backward()
    assert all(v.grad is not None for s in ts["g"].values()
               for v in s.values())
    assert all(v.grad is None for s in ts["d"].values() for v in s.values())
    for s in ts["g"].values():
        for v in s.values():
            v.grad = None
    tt.d_step(ts, "a", x, aux["fake_a"])
    assert all(v.grad is None for s in ts["g"].values() for v in s.values())


def test_spectral_norm_returns_detached_u():
    """The new u leaves the graph (JAX's stop_gradient), while sigma's
    gradient flows through u and v inside the call into w, unlike
    torch.nn.utils.spectral_norm, which detaches both."""
    g = torch.Generator().manual_seed(3)
    w = (torch.randn((4, 4, 3, 8), generator=g) * 0.02).requires_grad_(True)
    u = torch.randn(8, generator=g)
    wn, u_new = tcg._spectral_normalize(w, u)
    assert not u_new.requires_grad
    (gw,) = torch.autograd.grad(wn.sum(), w)
    wm = w.detach().reshape(-1, 8).T
    v = wm.T @ u
    v = v / v.norm()
    un = wm @ v
    un = un / un.norm()
    sigma = un @ (wm @ v)
    # torch's convention (u, v constant) gives another gradient
    assert not torch.allclose(gw, torch.ones_like(gw) / sigma
                              - (w.detach().sum() / sigma ** 2)
                              * torch.outer(v, un).reshape(w.shape),
                              atol=1e-6)
