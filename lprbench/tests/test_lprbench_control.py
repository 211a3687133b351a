"""The control of the correctness check, at a size a test run holds: the
reference in float8 e4m3 in the program's place fails the committed
limits of every configuration, on three seeds."""

import json

import pytest

from lprbench import check
from lprbench.frames import synth_frames
from lprbench.ref.pipeline import Reference
from lprbench.tests.conftest import ROOT, config, manifest, tiny


@pytest.mark.parametrize("name", [c["name"] for c in manifest()["configs"]])
@pytest.mark.parametrize("seed", [3, 4, 2**31 + 5])
def test_fp8_control_fails_the_limits(name, seed):
    cfg = tiny(config(name))
    limits = json.loads((ROOT / "lprbench" / "limits" / f"{name}.json")
                        .read_text())
    frames = synth_frames(4, tuple(cfg["frame_hw"]), seed % 2**32)
    ref = Reference(cfg, "cpu")
    answers = Reference(cfg, "cpu", fp8=True).serve(frames)
    nums = check.judge(list(enumerate(answers)), frames, ref, limits)
    assert not check.verdict(nums, limits, 0), nums
