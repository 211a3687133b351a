"""The enhancement-stage trainers on the card against the CPU (no JAX in
this file): the degradation on the same draws, one LPSR step with TF32
off, and validate's K2 float32 launches.  Marked ``cuda``; they skip
without a card.  Run on the card with ``python -m pytest -q -m cuda
tests/test_torch_train_cuda.py``."""

import numpy as np
import pytest
import torch

from lpr_tpu_torch.data.degradation import LPDegradation
from lpr_tpu_torch.models.lpsr import LPSRConfig, lpsr_init
from lpr_tpu_torch.train.lpsr import LPSRTrainer

SMALL = LPSRConfig()        # production widths; the batches stay small


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.fixture
def no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.mark.cuda
def test_degradation_on_card_matches_cpu_on_the_same_draws(no_tf32):
    """Draws sampled on the card, applied there and on the CPU: within
    1e-5 on [0, 1]."""
    _need_card()
    deg = LPDegradation(hr_hw=(64, 384))
    g = torch.Generator(device="cuda").manual_seed(0)
    hr = torch.rand((8, 64, 384, 3), device="cuda", generator=g)
    d = deg.sample(g, 8)
    got = deg.apply(d, hr).cpu()
    ref = deg.apply(d.to("cpu"), hr.cpu())
    assert float((got - ref).abs().max()) < 1e-5


@pytest.mark.cuda
def test_lpsr_step_on_card_matches_cpu(no_tf32):
    """One step of the production LPSR at batch 8 from the same fresh
    weights: the loss within 1e-5 relative, the gradients and weights as
    chip_smoke.py's train phase holds them (``_step_errors``: each
    gradient within TRAIN_GRAD_RTOL of the CPU's in norm, each weight
    within 1e-6 plus what that gradient difference moves a first Adam
    step)."""
    _need_card()
    from chip_smoke import TRAIN_GRAD_RTOL, _step_errors

    params = lpsr_init(torch.Generator().manual_seed(1), SMALL)
    rng = np.random.RandomState(2)
    lr = rng.rand(8, 32, 192, 3).astype(np.float32)
    hr = rng.rand(8, 32, 192, 1).astype(np.float32)
    states = {}
    for dev in ("cuda", "cpu"):
        t = LPSRTrainer(lpsr_cfg=SMALL, device=dev)
        s, loss = t.step(t.init(params=params), lr, hr)
        states[dev] = (s, float(loss))
    assert states["cuda"][1] == pytest.approx(states["cpu"][1], rel=1e-5)
    card, cpu = states["cuda"][0], states["cpu"][0]
    g_err, w_ratio, _, at = _step_errors(card["params"], card["opt"],
                                     cpu["params"], cpu["opt"], 1e-3, 0.9)
    assert g_err < TRAIN_GRAD_RTOL and w_ratio <= 1, (g_err, at, w_ratio)


@pytest.mark.cuda
def test_validate_on_card_launches_k2_once_a_batch(no_tf32):
    """After a step, validate launches K2 float32 once a batch, and its
    PSNR is LPSR.forward's on the stepped leaves within 0.01 dB."""
    _need_card()
    from lpr_tpu_torch.kernels import lpsr as kl

    t = LPSRTrainer(device="cuda")
    s = t.init(torch.Generator(device="cuda").manual_seed(3))
    g = torch.Generator(device="cuda").manual_seed(4)
    batches = [(torch.rand((n, 32, 192, 3), device="cuda", generator=g),
                torch.rand((n, 32, 192, 1), device="cuda", generator=g))
               for n in (5, 3, 4)]
    s, _ = t.step(s, *batches.pop())
    kl.lpsr_fused.launches = 0
    got = t.validate(s, batches)
    assert kl.lpsr_fused.launches == 2
    with torch.no_grad():
        ref = torch.cat([((t.forward(s["params"], x).clamp(0, 1) - y) ** 2)
                         .mean(dim=(1, 2, 3)) for x, y in batches])
    ref = float((10 * torch.log10(1 / ref.clamp_min(1e-12))).mean())
    assert got == pytest.approx(ref, abs=0.01)
