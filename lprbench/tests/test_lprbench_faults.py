"""A whole run of the harness on the CPU at a tiny size (the look for a
card skipped), once sound and once with the timed path broken underneath
for each fault a served cell can have: ``correct`` has to come out false
for every fault.  (The faults of a training or a multi-chip cell, a state
left unchanged by a step or an exchange left out, have their serving
counterparts here: a step that answers with an earlier batch's outputs.)"""

import numpy as np
import pytest
import torch

from lprbench import run
from lprbench.tests.conftest import TINY_MIX, config, manifest, tiny

CELL = "lpr720.closed64"


def _harness(fault=None, seed=2**31 + 99):
    cfg = tiny(config())

    def program(c, device):
        rec = run.build_program(c, device)
        if fault is not None:
            step = rec.step_raw
            rec.step_raw = lambda frames, *a, **k: fault(step, frames)
        return rec

    return run.run_cell(manifest(), CELL, seed, 6.0, False, device="cpu",
                        cfg_changes={k: cfg[k] for k in
                                     ("frame_hw", "pipeline")},
                        mix_changes=TINY_MIX, program=program)


def shift_boxes(step, frames):
    """An answer altered where it is produced: every plate box moved by a
    quarter of its width."""
    out = step(frames)
    b = out["plate_boxes"]
    dx = 0.25 * (b[..., 2] - b[..., 0])
    out["plate_boxes"] = b + torch.stack([dx, 0 * dx, dx, 0 * dx], -1)
    return out


def dim_sr(step, frames):
    """The SR image altered where LPSR produces it."""
    out = step(frames)
    out["sr"] = out["sr"] * 0.5
    return out


def wrong_chars(step, frames):
    """The strings altered where char NMS produces them: each character's
    class moved by one."""
    out = step(frames)
    for k in ("chars_orig", "chars_sr"):
        c = out[k]["classes"]
        out[k]["classes"] = torch.where(c >= 0, (c + 1) % 36, c)
    return out


def half_batch(step, frames):
    """Half of the batch left out: the first half's answers given to the
    rest."""
    n = len(frames)
    out = step(list(frames[:n // 2]) * 2)
    return out


class Stale:
    """A step that answers every batch with the first batch's outputs,
    as a step that leaves its state unchanged."""

    def __init__(self):
        self.first = None

    def __call__(self, step, frames):
        if self.first is None:
            self.first = step(frames)
        return {k: v for k, v in self.first.items()}


def test_a_sound_run_is_correct():
    out = _harness()
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"], out["check"]


@pytest.mark.parametrize("fault", [shift_boxes, dim_sr, wrong_chars,
                                   half_batch, Stale()],
                         ids=["answer", "sr", "chars", "half_batch",
                              "unchanged"])
def test_a_broken_step_is_not_correct(fault):
    out = _harness(fault)
    assert not out["correct"], out["check"]
    assert np.isfinite(list(v["value"] for v in out["check"].values())).all()
