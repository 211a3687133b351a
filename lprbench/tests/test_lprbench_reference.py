"""The plain reference against the port's eager step, both in float32 on
the CPU at a tiny size: the same plates, boxes within a small fraction of
a pixel, SR images and strings as the same stage computes them."""

import numpy as np
import torch

from lprbench import check
from lprbench.frames import synth_frames
from lprbench.ref.pipeline import Reference
from lprbench.run import build_program
from lprbench.tests.conftest import config, tiny


def test_reference_matches_the_ports_eager_step_in_float32():
    torch.manual_seed(0)
    cfg = tiny(config(), dtype="float32")
    rec = build_program(cfg, torch.device("cpu"))
    frames = synth_frames(8, tuple(cfg["frame_hw"]), 31)
    served = [(i, plates) for i, plates in enumerate(rec.recognize(frames))]
    assert sum(len(p) for _, p in served) >= 3     # plates to compare
    ref = Reference(cfg, "cpu")
    nums = check.judge(served, frames, ref, {})
    assert nums["plates_unexplained"] == 0
    assert nums["box_err_mean"] < 1e-4
    assert nums["score_err_mean"] < 1e-4
    assert nums["sr_err_mean"] < 1e-4
    assert nums["text_dist"] == 0


def test_reference_in_the_programs_place_reads_itself_exactly():
    cfg = tiny(config())
    frames = synth_frames(4, tuple(cfg["frame_hw"]), 32)
    ref = Reference(cfg, "cpu")
    answers = ref.serve(frames)
    nums = check.judge(list(enumerate(answers)), frames, ref, {})
    # the SR images are recomputed in another batch: oneDNN rounds by batch
    assert nums["sr_err_mean"] < 1e-6
    assert all(v == 0 for k, v in nums.items() if not k.startswith("sr"))
    assert all(isinstance(p["box"], np.ndarray) for a in answers for p in a)


def test_served_plates_have_to_be_the_references_top_plates():
    """A top plate left out, or a plate served that is not among them,
    is unexplained."""
    cfg = tiny(config())
    frames = synth_frames(4, tuple(cfg["frame_hw"]), 33)
    ref = Reference(cfg, "cpu")
    answers = ref.serve(frames)
    i = max(range(len(answers)), key=lambda k: len(answers[k]))
    assert answers[i], "a frame with plates"
    dropped = [list(a) for a in answers]
    dropped[i] = dropped[i][1:]
    nums = check.judge(list(enumerate(dropped)), frames, ref, {})
    assert nums["plates_unexplained"] >= 1
    moved = [list(a) for a in answers]
    p = dict(moved[i][0])
    h = p["box"][3] - p["box"][1]
    p["box"] = p["box"] + np.array([0.0, 2 * h, 0.0, 2 * h])
    moved[i][0] = p
    nums = check.judge(list(enumerate(moved)), frames, ref, {})
    assert nums["plates_unexplained"] >= 1
