"""The port's LR degradation and its ops against the JAX package's, on the
CPU.

JAX's PRNG stream is not reproduced in torch, so the stochastic parts are
held two ways: the deterministic application fed JAX's own draws (the
test replays the ``jax.random.split`` / ``fold_in`` chain of
``LPDegradation``'s per-image function and hands the values to the port),
and the port's sampler by its distributions.

Tolerances: the bicubic resize within 1e-6 of a float64 evaluation of
JAX's own weight matrices (``jax._src.image.scale.compute_weight_mat``,
run op by op) and within 3e-6 of ``jax.image.resize``, whose result under
jit on the CPU strays up to 2.1e-6 from that float64 value at the
degradation's x0.35 shrink (the port's 2.2e-7); the HSV scale and the
filters (kernels summing to 1) within 1e-6; the whole chain within 2e-6
on [0, 1] images; the motion kernels exactly (0/1 masks) and normalised
within 1e-7."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.data import degradation as jd
from lpr_tpu.ops import image as jim
from lpr_tpu_torch.data import degradation as td
from lpr_tpu_torch.ops import image as tim

from .train_ref import one_torch_thread  # noqa: F401

HW = (64, 384)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 64, 384, 3), (22, 134)),     # the degradation's x0.35 shrink
    ((2, 22, 134, 3), (11, 40)),
    ((2, 8, 16, 3), (16, 40)),        # grow
    ((2, 16, 32, 3), (24, 48)),
    ((16, 32, 3), (7, 3)),            # one image, HWC
])
def test_resize_bicubic_matches_jax(shape, out_hw):
    from jax._src.image import scale

    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    ref = np.asarray(jim.resize_bicubic(jnp.asarray(x), out_hw))
    got = tim.resize_bicubic(_t(x), out_hw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-6)
    h, w = shape[-3:-1]
    # op by op: under jit, XLA's rewrites move the weights by an ulp or so
    mats = [np.asarray(scale.compute_weight_mat(
        n, m, m / n, 0.0, scale._fill_keys_cubic_kernel, True), np.float64)
        for n, m in ((h, out_hw[0]), (w, out_hw[1]))]
    exact = np.einsum("...hwc,ho,wp->...opc", x.astype(np.float64), *mats)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)


def test_hsv_value_scale_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.rand(2, 16, 32, 3).astype(np.float32)
    x[0, :2] = 0.0                      # V = 0
    s = (rng.rand(2, 16, 32) * 3).astype(np.float32)   # clipping too
    ref = np.asarray(jim.hsv_value_scale(jnp.asarray(x), jnp.asarray(s)))
    got = tim.hsv_value_scale(_t(x), _t(s)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_filters_match_jax():
    rng = np.random.RandomState(2)
    img = rng.rand(40, 72, 3).astype(np.float32)
    kern = rng.rand(13, 13).astype(np.float32)
    kern /= kern.sum()
    np.testing.assert_allclose(
        td.apply_kernel(_t(img), _t(kern)).numpy(),
        np.asarray(jd.apply_kernel(jnp.asarray(img), jnp.asarray(kern))),
        rtol=0, atol=1e-6)
    for sigma in (1.5, 2.3, 3.0):
        np.testing.assert_allclose(
            td.gaussian_kernel_1d(torch.tensor(sigma)).numpy(),
            np.asarray(jd.gaussian_kernel_1d(jnp.float32(sigma))),
            rtol=0, atol=1e-7)
        np.testing.assert_allclose(
            td.gaussian_blur(_t(img), torch.tensor(sigma)).numpy(),
            np.asarray(jd.gaussian_blur(jnp.asarray(img),
                                        jnp.float32(sigma))),
            rtol=0, atol=1e-6)
    # batched: a kernel and a sigma per image
    imgs = rng.rand(3, 40, 72, 3).astype(np.float32)
    kerns = rng.rand(3, 11, 11).astype(np.float32)
    kerns /= kerns.sum(axis=(1, 2), keepdims=True)
    sig = np.array([1.5, 2.0, 2.9], np.float32)
    got_k = td.apply_kernel(_t(imgs), _t(kerns)).numpy()
    got_g = td.gaussian_blur(_t(imgs), _t(sig)).numpy()
    for i in range(3):
        np.testing.assert_allclose(got_k[i], np.asarray(jd.apply_kernel(
            jnp.asarray(imgs[i]), jnp.asarray(kerns[i]))), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_g[i], np.asarray(jd.gaussian_blur(
            jnp.asarray(imgs[i]), jnp.float32(sig[i]))), rtol=0, atol=1e-6)


def _jax_draws(key, cfg, hw):
    """The draws LPDegradation's per-image function makes from ``key``,
    replayed with its own split / fold_in chain (lpr_tpu/data/
    degradation.py ``one`` and the functions it calls)."""
    h, w = hw
    ks = jax.random.split(key, 6)
    k1, k2 = jax.random.split(ks[0])             # motion_kernel
    line = jax.random.uniform(k1) > 0.5
    l1, l2, l3 = jax.random.split(k2, 3)          # _line_kernel
    lsize = jax.random.randint(l1, (), 7, td.KMAX + 1)
    w4 = jax.random.split(k2, 4)                  # _walk_kernel
    wsize = jax.random.randint(w4[0], (), 7, td.KMAX + 1)
    l6 = jax.random.split(ks[2], 6)               # lighting_mask
    gk = jax.random.fold_in(key, 7)               # glare
    g4 = jax.random.split(jax.random.fold_in(gk, 1), 4)
    dh, dw = max(int(h * cfg.scale), 1), max(int(w * cfg.scale), 1)

    def u(k, lo=0.0, hi=1.0, shape=()):
        return jax.random.uniform(k, shape, minval=lo, maxval=hi)

    return dict(
        line=line, size=jnp.where(line, lsize, wsize),
        angle=u(l2, 0.0, 2 * jnp.pi), length=u(l3, 1.0, 2.0) * (lsize / 4.0),
        n_steps=jax.random.randint(w4[1], (), 5, 11),
        angle0=u(w4[2], 0.0, 360.0), deltas=u(w4[3], shape=(10, 2)),
        motion_u=u(ks[1]),
        light_choice=jax.random.randint(l6[0], (), 0, 3),
        intensity=u(l6[1], *cfg.brightness_weight_range),
        horiz=u(l6[2]) < 0.5, flip=u(l6[3]) < 0.5,
        spot_x=jax.random.randint(l6[4], (), 0, w),
        spot_y=jax.random.randint(l6[5], (), 0, h),
        light_u=u(ks[3]), glare_u=u(gk),
        glare_x=u(g4[0], 0.08 * w, 0.92 * w),
        glare_y=u(g4[1], 0.25 * h, 0.75 * h),
        glare_r=u(g4[2], *cfg.glare_radius_range) * h,
        glare_alpha=u(g4[3], *cfg.glare_alpha_range),
        sigma=u(ks[4], *cfg.gaussian_sigma_range),
        noise_level=u(ks[5], *cfg.noise_level_range),
        noise=jax.random.normal(jax.random.fold_in(ks[5], 1), (dh, dw, 3)),
    )


def _replayed(key, n, cfg, hw):
    """JAX's draws for LPDegradation.__call__(key, batch of n) as the
    port's Draws, and the per-image keys (vmapped and jitted, as JAX's
    chain runs them: one compile, not one a key)."""
    keys = jax.random.split(key, n)
    ds = jax.jit(jax.vmap(lambda k: _jax_draws(k, cfg, hw)))(keys)
    return td.Draws(**{f: torch.from_numpy(np.array(v))
                       for f, v in ds.items()}), keys


@pytest.fixture(scope="module")
def replay():
    cfg = jd.DegradationConfig()
    d, keys = _replayed(jax.random.PRNGKey(5), 8, cfg, HW)
    return cfg, d, keys


def _jax_batch(fn, *args):
    return np.asarray(jax.jit(jax.vmap(fn))(*args))


def test_motion_kernels_match_jax_on_its_draws(replay):
    """Both branches' kernels (the streak and the walk) and the selected,
    normalised one, per image, equal JAX's."""
    cfg, d, keys = replay
    k0 = jax.vmap(lambda k: jax.random.split(k, 6)[0])(keys)
    k2 = jax.vmap(lambda k: jax.random.split(k)[1])(k0)
    line = td.line_kernel(d.size, d.angle, d.length).numpy()
    walk = td.walk_kernel(d.size, d.n_steps, d.angle0, d.deltas).numpy()
    is_line = d.line.numpy()
    np.testing.assert_array_equal(line[is_line],
                                  _jax_batch(jd._line_kernel, k2)[is_line])
    np.testing.assert_array_equal(walk[~is_line],
                                  _jax_batch(jd._walk_kernel, k2)[~is_line])
    np.testing.assert_allclose(td.motion_kernel(d).numpy(),
                               _jax_batch(jd.motion_kernel, k0), rtol=0,
                               atol=1e-7)
    assert is_line.any() and not is_line.all()


def test_lighting_and_glare_match_jax_on_its_draws(replay):
    cfg, d, keys = replay
    img = np.random.RandomState(3).rand(len(keys), *HW, 3).astype(np.float32)
    ref = _jax_batch(lambda k: jd.lighting_mask(
        jax.random.split(k, 6)[2], HW, cfg.brightness_weight_range), keys)
    np.testing.assert_allclose(td.lighting_mask(d, HW).numpy(), ref,
                               rtol=0, atol=1e-6)
    ref = _jax_batch(lambda k, x: jd.glare_blob(
        jax.random.fold_in(jax.random.fold_in(k, 7), 1), x,
        cfg.glare_radius_range, cfg.glare_alpha_range), keys,
        jnp.asarray(img))
    glared = td.glare_blob(_t(img), d.glare_x, d.glare_y, d.glare_r,
                           d.glare_alpha).numpy()
    np.testing.assert_allclose(glared, ref, rtol=0, atol=1e-6)
    assert set(d.light_choice.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("p_glare", [0.0, 1.0])
def test_chain_matches_jax_on_its_draws(p_glare):
    """LPDegradation(key, hr) against the port's apply on the replayed
    draws, 8 images of 64x384 -> 32x192."""
    jcfg = jd.DegradationConfig(p_glare=p_glare)
    tcfg = td.DegradationConfig(p_glare=p_glare)
    hr = np.random.RandomState(4).rand(8, *HW, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jd.LPDegradation(jcfg, HW)(key, jnp.asarray(hr)))
    d, _ = _replayed(key, 8, jcfg, HW)
    got = td.LPDegradation(tcfg, HW).apply(d, _t(hr)).numpy()
    assert got.shape == ref.shape == (8, 32, 192, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_samplers_keep_jax_distributions():
    """2,000 draws: motion kernel sizes 7-13 (each seen), every kernel
    sums to 1, and the motion / lighting / glare rates near 0.7 / 0.3 /
    p_glare (binomial, n = 2,000: 4 sigma is ~0.04); the other values in
    their ranges."""
    n = 2000
    deg = td.LPDegradation(td.DegradationConfig(p_glare=0.25), HW)
    d = deg.sample(torch.Generator().manual_seed(0), n)
    cfg = deg.cfg
    assert set(d.size.tolist()) == set(range(7, 14))
    sums = td.motion_kernel(d).sum(dim=(1, 2))
    np.testing.assert_allclose(sums.numpy(), 1.0, atol=1e-5)
    for taken, p in ((d.motion_u < cfg.p_motion, cfg.p_motion),
                     (d.light_u < cfg.p_lighting, cfg.p_lighting),
                     (d.glare_u < cfg.p_glare, cfg.p_glare),
                     (d.line, 0.5)):
        assert abs(float(taken.float().mean()) - p) < 0.04
    assert set(d.light_choice.tolist()) == {0, 1, 2}
    assert set(d.n_steps.tolist()) == set(range(5, 11))
    for v, (lo, hi) in ((d.sigma, cfg.gaussian_sigma_range),
                        (d.noise_level, cfg.noise_level_range),
                        (d.intensity, cfg.brightness_weight_range),
                        (d.angle, (0.0, 2 * math.pi)),
                        (d.angle0, (0.0, 360.0))):
        assert lo <= float(v.min()) and float(v.max()) < hi
    assert ((d.length >= d.size / 4.0) & (d.length < d.size / 2.0)).all()
    assert d.noise.shape == (n, 22, 134, 3)
    assert abs(float(d.noise.std()) - 1.0) < 0.01


def test_sample_then_apply_is_reproducible_and_in_range():
    deg = td.LPDegradation()
    hr = torch.rand((4, *HW, 3), generator=torch.Generator().manual_seed(1))
    a = deg(torch.Generator().manual_seed(7), hr)
    b = deg(torch.Generator().manual_seed(7), hr)
    assert torch.equal(a, b) and a.shape == (4, 32, 192, 3)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_estimated_kernels_match_jax(tmp_path):
    """load_estimated_kernels on .mat files written here (several arrays a
    file, other sizes, a non-.mat file beside them), and
    apply_estimated_kernel's filter."""
    from scipy.io import savemat

    rng = np.random.RandomState(6)
    savemat(tmp_path / "a.mat", {"k1": rng.rand(17, 17),
                                 "k2": rng.rand(9, 13)})
    savemat(tmp_path / "b.mat", {"k": rng.rand(25, 25).astype(np.float32)})
    (tmp_path / "notes.txt").write_text("not a kernel")
    ref = jd.load_estimated_kernels(str(tmp_path))
    got = td.load_estimated_kernels(str(tmp_path))
    assert got.shape == ref.shape == (3, 11, 11)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert td.load_estimated_kernels(str(empty)).shape == (0, 11, 11)
    img = rng.rand(2, 24, 40, 3).astype(np.float32)
    out = td.apply_estimated_kernel(torch.Generator().manual_seed(0),
                                    _t(img), _t(got)).numpy()
    assert out.shape == img.shape and out.min() >= 0 and out.max() <= 1
    matches = [[np.allclose(out[b], np.clip(np.asarray(jd.apply_kernel(
        jnp.asarray(img[b]), jnp.asarray(ref[i]))), 0, 1), atol=1e-6)
        for i in range(3)] for b in range(2)]
    assert all(any(m) for m in matches)
