"""K4, K1's stage variants (the port of tools/probe_front_stages.py
``make_variant``): the port's plain versions against the JAX variants run
in interpret mode, their layouts, the wrapper's dispatch and work count,
and (on a card) each CUDA variant against its plain version."""

import functools
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.ops.pallas import yolo_front as jfront
from lpr_tpu_torch.kernels import yolo_front as kf
from lpr_tpu_torch.models import yolo as tyolo

from . import torch_ref
from .torch_ref import PLATE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX variants take one geometry only, the production 736x1280.
DET_HW = (736, 1280)


def _frames(n, hw, seed):
    return np.random.RandomState(seed).rand(n, *hw, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_variants(tmp_path_factory):
    """The four JAX variants' outputs at batch 1 on the real weights, each
    unpacked as front_fused unpacks K1's (lane pad dropped, NHWC), and the
    input frame they ran on.  The tool module sets JAX_COMPILATION_CACHE_DIR
    by setdefault and prepends the repo to sys.path when imported; both are
    undone after the fixture, as is the interpret-mode pallas_call."""
    from jax.experimental import pallas as pl

    model, params = torch_ref.plate()
    w = jfront.front_pack_from_params(model, params)
    x = jnp.asarray(_frames(1, DET_HW, 0), jnp.bfloat16)
    xp = jfront.pack_front_frames(x)
    g = jfront._G0
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR",
                  str(tmp_path_factory.mktemp("jax_cache")))
        mp.setattr(sys, "path", list(sys.path))
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        spec = importlib.util.spec_from_file_location(
            "_jax_probe_front_stages",
            os.path.join(ROOT, "tools", "probe_front_stages.py"))
        probe = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(probe)
        for stage in kf.STAGES:
            out = probe.make_variant(stage)(xp, w)
            out = np.asarray(out.astype(jnp.float32)).reshape(
                1, 64, g.c3rows, g.cp)[..., 4:4 + g.cols]
            outs[stage] = out.transpose(0, 2, 3, 1)
    return outs, np.asarray(x.astype(jnp.float32))


@pytest.fixture(scope="module")
def packed_bf16_weights():
    """The port's packed front weights with the weights (not the biases)
    rounded to bf16, as lpr_tpu's pack_front_weights rounds them."""
    packed = kf.front_pack(tyolo.load_plate_detector(PLATE, device="cpu"))
    return {k: v.to(torch.bfloat16).float() if k.startswith("w") else v
            for k, v in packed.items()}


@pytest.mark.parametrize("stage", kf.STAGES)
def test_stage_plain_matches_jax_make_variant(jax_variants,
                                              packed_bf16_weights, stage):
    """front_stage_plain vs make_variant(stage) in interpret mode, bf16,
    (1, 736, 1280, 3), real weights.  The JAX dma and stem variants write
    their stage two quarter-rows late (rows 0-1 zero); the port's write the
    stage's own rows, so the port's rows 0..181 are held against the JAX
    rows 2..183 there.  dma is a copy (exact); the rest round at the same
    points, within K1's bound (front_errors)."""
    outs, x = jax_variants
    ref = outs[stage]
    got = kf.front_stage_plain(torch.from_numpy(x).to(torch.bfloat16),
                               packed_bf16_weights, stage)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 184, 320, 64)
    got = got.float().numpy()
    if stage in ("dma", "stem"):
        assert not ref[:, :2].any()
        ref, got = ref[:, 2:], got[:, :-2]
    if stage == "dma":
        np.testing.assert_array_equal(got, ref)
        return
    _, ratio, interior = kf.front_errors(torch.from_numpy(got),
                                         torch.from_numpy(ref))
    assert ratio < 1.0, ratio
    assert interior < kf.TOL_INTERIOR_MEAN, interior


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_stage_is_front_plain(dtype):
    packed = kf.front_pack(tyolo.load_plate_detector(PLATE, device="cpu"))
    x = torch.from_numpy(_frames(2, (64, 128), 1)).to(dtype)
    assert torch.equal(kf.front_stage_plain(x, packed, "full"),
                       kf.front_plain(x, packed))


def test_stage_layouts_at_small_size():
    """dma holds the frame's pixels as STAGES describes; stem holds the
    even rows of the plain stem, even columns then odd; down is the plain
    down conv."""
    packed = kf.front_pack(tyolo.load_plate_detector(PLATE, device="cpu"))
    img = _frames(1, (64, 128), 2)
    x = torch.from_numpy(img)
    dma = kf.front_stage_plain(x, packed, "dma").numpy()
    for y, xx, rho, pi, c, i, j in [(0, 0, 0, 0, 0, 0, 0),
                                    (3, 7, 1, 0, 2, 1, 1),
                                    (15, 31, 1, 1, 1, 0, 1)]:
        p = 2 * rho + pi
        assert dma[0, y, xx, p * 16 + c * 4 + i * 2 + j] == \
            img[0, 4 * y + 2 * rho + i, 4 * xx + 2 * pi + j, c]
    assert not dma.reshape(1, 16, 32, 4, 16)[..., 12:].any()
    stem = kf._chain(x, packed, "stem")                      # NCHW
    got = kf.front_stage_plain(x, packed, "stem")
    assert torch.equal(got[..., :32], stem[:, :, ::2, ::2].permute(0, 2, 3, 1))
    assert torch.equal(got[..., 32:],
                       stem[:, :, ::2, 1::2].permute(0, 2, 3, 1))
    down = kf._chain(x, packed, "down").permute(0, 2, 3, 1)
    assert torch.equal(kf.front_stage_plain(x, packed, "down"), down)


def test_wrapper_takes_plain_version_on_cpu():
    packed = kf.front_pack(tyolo.load_plate_detector(PLATE, device="cpu"))
    x = torch.from_numpy(_frames(1, (64, 128), 3))
    before = dict(kf.front_stage.launches)
    for stage in kf.STAGES:
        assert torch.equal(kf.front_stage(x, packed, stage),
                           kf.front_stage_plain(x, packed, stage))
    assert kf.front_stage.launches == before      # no kernel launch
    with pytest.raises(ValueError):
        kf.front_stage(x, packed, "c3")
    with pytest.raises(ValueError):
        kf.front_stage(x.to("meta"), packed, "stem")


def test_front_stage_work_at_the_production_shape():
    """At (8, 736, 1280, 3): 45.2 MB in and 60.3 MB out for every variant
    (31.5 us at 3.35 TB/s); stem 13.0 GFLOP, down 30.4 cumulative, full
    47.75 (= front_work).  dma, stem and down are bounded by bytes, full
    by operations (989 TFLOP/s)."""
    io = 8 * (736 * 1280 * 3 * 2 + 184 * 320 * 64 * 2)
    assert io == pytest.approx(45.2e6 + 60.3e6, rel=1e-3)
    flops = {}
    for stage in kf.STAGES:
        f, nbytes = kf.front_stage_work(stage, 8, 736, 1280)
        assert 0 <= nbytes - io < 2e5
        flops[stage] = f
        by_ops = f / 989e12 > nbytes / 3.35e12
        assert by_ops == (stage == "full")
    assert flops["dma"] == 0
    assert flops["stem"] == pytest.approx(13.0e9, rel=2e-3)
    assert flops["down"] == pytest.approx(30.4e9, rel=2e-3)
    assert kf.front_stage_work("full", 8, 736, 1280) == kf.front_work(
        8, 736, 1280)
    with pytest.raises(ValueError):
        kf.front_stage_work("c3", 8, 736, 1280)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", kf.STAGES)
def test_stage_kernel_matches_plain_version_on_card(stage):
    """Each variant vs front_stage_plain on the card, bf16, real weights,
    (2, 736, 1280, 3): dma exact, stem and down within K1's bound, full
    bit-identical to K1 (the same instance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    model = tyolo.load_plate_detector(PLATE, device="cuda").to(torch.bfloat16)
    p = kf.front_pack(model)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((2, *DET_HW, 3), generator=g, device="cuda"
                   ).to(torch.bfloat16)
    before = kf.front_stage.launches[stage]
    got = kf.front_stage(x, p, stage)
    ref = kf.front_stage_plain(x, p, stage)
    torch.cuda.synchronize()
    assert kf.front_stage.launches[stage] == before + 1
    if stage == "dma":
        assert torch.equal(got, ref)
        return
    if stage == "full":
        assert torch.equal(got, kf.yolo_front(x, p))
    _, ratio, interior = kf.front_errors(got, ref)
    assert ratio < 1.0 and interior < kf.TOL_INTERIOR_MEAN
