"""On the card (marked ``cuda``; skipped elsewhere): a short run of each
closed cell at its full size is correct, and the float8 control at the
cell's size is not."""

import json

import pytest
import torch

from lprbench import check, run
from lprbench.frames import synth_frames
from lprbench.ref.pipeline import Reference
from lprbench.tests.conftest import ROOT, config, manifest

CLOSED = [w["name"] for w in manifest()["workloads"]
          if w["traffic"] == "closed64"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CLOSED)
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = run.run_cell(manifest(), cell, 2**31 + 11, 2.0, False,
                       device="cuda")
    assert out["correct"], out["check"]
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c["name"] for c in manifest()["configs"]])
def test_the_fp8_control_fails_on_the_card(card, name):
    cfg = config(name)
    limits = json.loads((ROOT / "lprbench" / "limits" / f"{name}.json")
                        .read_text())
    frames = synth_frames(8, tuple(cfg["frame_hw"]), 2**31 + 12)
    ref = Reference(cfg, card)
    answers = Reference(cfg, card, fp8=True).serve(frames)
    nums = check.judge(list(enumerate(answers)), frames, ref, limits)
    assert not check.verdict(nums, limits, 0), nums
