"""The port's models against the JAX package's apply, on the CPU, with the
repo's own checkpoints (float32 on both sides, JAX at 'highest').

The port folds batch norm into the convolutions at load while the JAX
model applies it after each conv, and cuDNN/oneDNN sum in another order
than XLA, so each layer differs by float32 rounding; through a deep
network that stays far below the stated tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.models import lpsr as jlpsr
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as tyolo

from . import torch_ref
from .torch_ref import CHAR, LPSR, PLATE


@pytest.mark.parametrize("which", ["plate", "char"])
def test_yolo_raw_output_matches_jax(which):
    """Raw Detect logits of the plate model (1x128x256) and the char model
    (1x128x128).  Tolerance 2e-3 absolute on logits of magnitude up to ~20:
    float32 rounding accumulated over ~25 conv layers."""
    if which == "plate":
        jm, jp = torch_ref.plate()
        tm = tyolo.load_plate_detector(PLATE, device="cpu")
        shape = (1, 128, 256, 3)
    else:
        jm, jp, _ = torch_ref.char()
        tm, _, ck = tyolo.load_char_ocr_npz(CHAR, device="cpu")
        names = ck.names
        assert len(names) == 36
        np.testing.assert_array_equal(tm.anchors, jm.anchors)
        shape = (1, 128, 128, 3)
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    ref = jax.jit(lambda p, v: jm.apply(p, v, decode=False))(
        jp, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert tm.strides == jm.strides
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=2e-3)


def test_lpsr_matches_jax():
    """LPSR on lpsr_synth_glare at 2x32x192 (sigmoid output in (0, 1))."""
    cfg = jlpsr.LPSRConfig()
    jp = torch_ref.lpsr()
    tm = tlpsr.load_lpsr(LPSR, tlpsr.LPSRConfig(), device="cpu")
    x = np.random.RandomState(1).rand(2, 32, 192, 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jlpsr.lpsr_apply(p, v, cfg))(
        jp, jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 32, 192, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_lpsr_config_quirks():
    assert tlpsr.LPSRConfig().executed_rdbs == jlpsr.LPSRConfig().executed_rdbs
    tm = tlpsr.load_lpsr(LPSR, device="cpu")
    assert len(tm.rdbs) == 2       # RDB0, RDB2 executed; one shared CSAR
    alphas = [float(r.alpha) for r in tm.rdbs]
    assert all(np.isfinite(alphas))
