"""The port's LPSR trainer against the JAX package's, on the CPU: the same
initial weights on both sides (made by the port's ``lpsr_init`` and placed
into JAX's pytree, ``tests/train_ref.py``), the same batches; float32 on
both sides (JAX convolutions at 'highest').

Tolerances: the loss within 1e-6 relative, each gradient within 1e-5 of
its largest magnitude (oneDNN and XLA sum in other orders), the weights
after three Adam steps within 1e-6 absolute (each step moves a weight by
at most ~lr = 1e-3, so rounding of the update stays far below)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.models import lpsr as jlpsr
from lpr_tpu.train import lpsr as jtrain
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.train import lpsr as ttrain
from lpr_tpu_torch.weights.checkpoint import params_from_jax, save_state

from .train_ref import (jax_tree, key_of, one_torch_thread,  # noqa: F401
                        shapes)

TINY_J = jlpsr.LPSRConfig(num_features=8, growth_rate=4, num_blocks=2,
                          num_layers=2)
TINY_T = tlpsr.LPSRConfig(num_features=8, growth_rate=4, num_blocks=2,
                          num_layers=2)


def _batch(seed, b=4, h=8, w=16):
    rng = np.random.RandomState(seed)
    lr = rng.rand(b, h, w, 3).astype(np.float32)
    return lr, lr.mean(-1, keepdims=True).astype(np.float32)


def _pair(seed=0):
    """(JAX trainer, JAX state, port trainer, port state) from the same
    initial weights."""
    flat = tlpsr.lpsr_init(torch.Generator().manual_seed(seed), TINY_T)
    jt = jtrain.LPSRTrainer(jtrain.LPSRTrainConfig(), TINY_J)
    js = jt.init(params=jax_tree(jlpsr.lpsr_init, flat, TINY_J))
    tt = ttrain.LPSRTrainer(ttrain.LPSRTrainConfig(), TINY_T, device="cpu")
    ts = tt.init(params=params_from_jax(jax.device_get(js["params"])))
    return jt, js, tt, ts


def test_psnr_matches_jax():
    x = np.random.RandomState(0).rand(3, 8, 16, 1).astype(np.float32)
    y = np.random.RandomState(1).rand(3, 8, 16, 1).astype(np.float32)
    ref = np.asarray(jtrain.psnr(jnp.asarray(x), jnp.asarray(y)))
    got = ttrain.psnr(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    z = ttrain.psnr(torch.zeros(2, 4, 4, 1), torch.full((2, 4, 4, 1), 0.1))
    np.testing.assert_allclose(z.numpy(), 20.0, atol=1e-4)


def test_loss_and_gradients_match_jax():
    jt, js, tt, ts = _pair()
    lr, hr = _batch(1)

    def loss_fn(p):
        pred = jlpsr.lpsr_apply(p, jnp.asarray(lr), TINY_J)
        return jnp.mean((pred - jnp.asarray(hr)) ** 2)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(js["params"])
    ref_grads = params_from_jax(jax.device_get(ref_grads))
    loss = tt.loss(ts["params"], torch.from_numpy(lr), torch.from_numpy(hr))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    assert ref_grads.keys() == ts["params"].keys()
    for k, g in ref_grads.items():
        got = ts["params"][k].grad.numpy()       # HWIO, as JAX's
        assert got.shape == g.shape, k
        np.testing.assert_allclose(got, g, rtol=0,
                                   atol=1e-5 * max(np.abs(g).max(), 1e-3),
                                   err_msg=k)


def test_three_adam_steps_match_jax():
    jt, js, tt, ts = _pair(2)
    for i in range(3):
        lr, hr = _batch(10 + i)
        js, jloss = jt.step(js, jnp.asarray(lr), jnp.asarray(hr))
        ts, tloss = tt.step(ts, lr, hr)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ref = params_from_jax(jax.device_get(js["params"]))
    for k, v in ref.items():
        np.testing.assert_allclose(ts["params"][k].detach().numpy(), v,
                                   rtol=0, atol=1e-6, err_msg=k)


def test_plateau_update_matches_jax():
    cfg_j = jtrain.LPSRTrainConfig(plateau_patience=1, lr=1e-3, min_lr=3e-4)
    cfg_t = ttrain.LPSRTrainConfig(plateau_patience=1, lr=1e-3, min_lr=3e-4)
    jt = jtrain.LPSRTrainer(cfg_j, TINY_J)
    tt = ttrain.LPSRTrainer(cfg_t, TINY_T, device="cpu")
    js = {"lr_scale": jnp.float32(1.0), "best_psnr": -np.inf,
          "bad_epochs": 0}
    ts = {"lr_scale": 1.0, "best_psnr": -math.inf, "bad_epochs": 0}
    for v in (10.0, 9.0, 9.0, 11.0, 8.0, 8.0, 8.0, 8.0, 8.0, 12.0):
        js, ts = jt.plateau_update(js, v), tt.plateau_update(ts, v)
        assert ts["bad_epochs"] == js["bad_epochs"]
        assert ts["best_psnr"] == js["best_psnr"]
        np.testing.assert_allclose(ts["lr_scale"], float(js["lr_scale"]),
                                   rtol=1e-7)
    assert ts["lr_scale"] == pytest.approx(0.3)   # floored at min_lr / lr


def test_validate_matches_jax_forward_route():
    """TINY is not a configuration K2 takes: LPSR.forward, as JAX's
    eval step."""
    jt, js, tt, ts = _pair(3)
    batches = [_batch(20), _batch(21)]
    ref = jt.validate(js, [(jnp.asarray(a), jnp.asarray(b))
                           for a, b in batches])
    got = tt.validate(ts, batches)
    assert got == pytest.approx(ref, abs=1e-4)


def test_validate_after_steps_matches_jax():
    """validate reads the weights the steps made: two Adam steps on each
    side from the same start, then each side's validate on its own stepped
    weights (LPSR.forward, as above)."""
    jt, js, tt, ts = _pair(4)
    batches = [_batch(20), _batch(21)]
    start = tt.validate(ts, batches)
    for i in range(2):
        lr, hr = _batch(30 + i)
        js, _ = jt.step(js, jnp.asarray(lr), jnp.asarray(hr))
        ts, _ = tt.step(ts, lr, hr)
    ref = jt.validate(js, [(jnp.asarray(a), jnp.asarray(b))
                           for a, b in batches])
    got = tt.validate(ts, batches)
    assert got == pytest.approx(ref, abs=1e-4)
    assert abs(got - start) > 100 * 1e-4       # the steps moved it


def test_validate_production_runs_k2_plain_version(monkeypatch):
    """The production configuration (the repo's lpsr_synth_glare weights,
    then one port step) validates through lpsr_fused, whose plain version
    runs on the CPU: once per batch, on the stepped weights; its PSNR
    agrees with JAX's lpsr_apply on those weights within 1e-3 dB."""
    from lpr_tpu_torch.weights.checkpoint import load_state

    from .torch_ref import LPSR

    from lpr_tpu_torch.kernels import lpsr as kl

    calls = []
    plain = kl.lpsr_plain
    monkeypatch.setattr(kl, "lpsr_plain",
                        lambda x, p: calls.append(x.shape) or plain(x, p))
    tt = ttrain.LPSRTrainer(device="cpu")
    ts = tt.init(params=load_state(LPSR)[0])
    rng = np.random.RandomState(5)
    batches = [(rng.rand(2, 32, 192, 3).astype(np.float32),
                rng.rand(2, 32, 192, 1).astype(np.float32))
               for _ in range(3)]
    ts, _ = tt.step(ts, *batches.pop())
    stepped = {k: v.detach().numpy() for k, v in ts["params"].items()}
    jt = jtrain.LPSRTrainer(jtrain.LPSRTrainConfig())
    js = jt.init(params=jax_tree(jlpsr.lpsr_init, stepped,
                                 jlpsr.LPSRConfig()))
    ref = jt.validate(js, [(jnp.asarray(a), jnp.asarray(b))
                           for a, b in batches])
    got = tt.validate(ts, batches)
    assert calls == [(2, 32, 192, 3)] * 2
    assert got == pytest.approx(ref, abs=1e-3)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """save_state writes what lpr_tpu.weights.checkpoint.load_params reads:
    the same forward on both sides, and the port's load_state reads it
    back equal."""
    from lpr_tpu.weights.checkpoint import load_params
    from lpr_tpu_torch.weights.checkpoint import load_state

    tt = ttrain.LPSRTrainer(ttrain.LPSRTrainConfig(), TINY_T, device="cpu")
    ts = tt.init(torch.Generator().manual_seed(6))
    lr, hr = _batch(7)
    ts, _ = tt.step(ts, lr, hr)
    path = str(tmp_path / "m.npz")
    save_state(path, ts["params"])
    like = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        shapes(jlpsr.lpsr_init, TINY_J))
    jp = load_params(path, like)
    ref = np.asarray(jax.jit(lambda p, x: jlpsr.lpsr_apply(p, x, TINY_J))(
        jp, jnp.asarray(lr)))
    with torch.no_grad():
        got = tt.forward(ts["params"], torch.from_numpy(lr)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    back, _ = load_state(path)
    for k, v in ts["params"].items():
        np.testing.assert_array_equal(back[k], v.detach().numpy())


def test_loss_decreases():
    tt = ttrain.LPSRTrainer(ttrain.LPSRTrainConfig(lr=3e-3), TINY_T,
                            device="cpu")
    ts = tt.init(torch.Generator().manual_seed(0))
    lr, hr = _batch(1, b=8)
    losses = [float(tt.step(ts, lr, hr)[1]) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.7


@pytest.mark.parametrize("which", ["lpsr", "generator", "discriminator"])
def test_inits_match_jax_layout_and_moments(which):
    """Fresh weights: the keys and shapes of JAX's init, and moments of
    JAX's distributions (uniform +-sqrt(1/fan_in): mean 0, var bound^2/3;
    normal(0, 0.02) convs, zero biases, normal(0, 1) u)."""
    from lpr_tpu.models import cyclegan as jcg
    from lpr_tpu_torch.models import cyclegan as tcg

    g = torch.Generator().manual_seed(0)
    if which == "lpsr":
        ref = shapes(jlpsr.lpsr_init, jlpsr.LPSRConfig())
        got = tlpsr.lpsr_init(g)
    elif which == "generator":
        cfg = jcg.GeneratorConfig(n_resnet_blocks=2, base=16)
        ref = shapes(jcg.generator_init, cfg)
        got = tcg.generator_init(g, tcg.GeneratorConfig(n_resnet_blocks=2,
                                                        base=16))
    else:
        ref = shapes(jcg.discriminator_init, 3)
        got = tcg.discriminator_init(g, 3)
    leaves_, _ = jax.tree_util.tree_flatten_with_path(ref)
    ref = {key_of(p): a for p, a in leaves_}
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == np.float32, k
        x = got[k].astype(np.float64)
        if which == "lpsr":
            if k.endswith("alpha"):
                assert x == 1.0
                continue
            w = ref[k[:-1] + "w"]          # a dense (in, out) or HWIO
            fan_in = w.shape[0] if "ca_fc" in k else int(np.prod(w.shape[:-1]))
            bound = math.sqrt(1.0 / fan_in)
            assert np.abs(x).max() <= bound, k
            if x.size >= 500:
                assert abs(x.mean()) < 0.1 * bound, k
                assert x.var() == pytest.approx(bound ** 2 / 3, rel=0.15), k
        elif k.endswith("/b"):
            assert not x.any(), k
        else:
            std = 1.0 if k.endswith("/u") else 0.02
            if x.size >= 500:
                assert abs(x.mean()) < 0.1 * std, k
                assert x.std() == pytest.approx(std, rel=0.1), k
