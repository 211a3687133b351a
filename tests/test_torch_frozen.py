"""The frozen step (``PipelineConfig.freeze_params``): on the CPU the step
that a card would capture as a CUDA graph makes no host-to-device table
after its first call, and gives what the eager step gives; on a card the
graph's replays equal the eager step bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from lpr_tpu_torch.kernels import yolo_front as kf
from lpr_tpu_torch.pipeline.recognizer import PlateRecognizer, to_host
from lpr_tpu_torch.tools import profile_stages
from lpr_tpu_torch.tools.synth import synth_frames


def _frames(seed, n=1, hw=(60, 120)):
    return np.random.RandomState(seed).randint(0, 256, (n, *hw, 3),
                                               dtype=np.uint8)


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict) or a[k] is None:
            assert (a[k] is None) == (b[k] is None), k
            if a[k] is not None:
                _assert_same(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module", params=[False, True], ids=["raw", "packed"])
def rec(request):
    return profile_stages.build_recognizer(
        "cpu", torch.float32, (64, 128), packed_input=request.param)


def test_second_step_makes_no_host_to_device_table(rec, monkeypatch):
    """After one call, a step on tensor inputs builds no tensor from host
    data (torch.from_numpy, torch.tensor, torch.as_tensor all raise): the
    constant tables are cached, which a CUDA graph capture needs, as no
    upload from pageable memory may happen while a stream is captured."""
    frames = torch.from_numpy(_frames(0))
    packed = rec.host_letterbox(frames)
    packed = None if packed is None else torch.from_numpy(packed)
    ref = to_host(rec.step_raw(frames, packed))

    def refuse(*args, **kwargs):
        raise AssertionError("a host table was built inside the step")

    for name in ("from_numpy", "tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, refuse)
    out = rec.step_raw(frames, packed)
    monkeypatch.undo()
    _assert_same(to_host(out), ref)


def test_freeze_params_gives_the_eager_outputs_on_cpu(rec):
    """On the CPU freeze_params=True runs the same eager step as
    freeze_params=False (there is no graph without a card)."""
    assert rec.cfg.freeze_params
    eager = PlateRecognizer(
        rec.plate_model, rec.char_model, rec.lpsr_model,
        dataclasses.replace(rec.cfg, freeze_params=False),
        char_names=rec.char_names, device="cpu")
    frames = _frames(1, 2)
    _assert_same(to_host(rec.step_raw(frames)),
                 to_host(eager.step_raw(frames)))
    _assert_same(to_host(rec.step_raw(frames)),
                 to_host(rec.step_eager(frames)))


def test_step_output_is_not_changed_by_the_next_step(rec):
    """A returned output stays as it was when the next step runs on other
    frames (on a card the graph's own buffers are overwritten: the step
    returns copies)."""
    first = rec.step_raw(_frames(2))
    kept = to_host(first)
    rec.step_raw(_frames(3))
    _assert_same(to_host(first), kept)


def test_letterboxed_frames_need_packed_input(rec):
    """Letterboxed frames passed to a recognizer without packed_input (whose
    K1 pack has no 1/255 in its stem) raise instead of running."""
    frames = _frames(6)
    if rec.cfg.packed_input:
        assert rec.host_letterbox(frames).shape == (1, 64, 128, 3)
    else:
        assert rec.host_letterbox(frames) is None
        with pytest.raises(ValueError):
            rec.step_raw(frames, np.zeros((1, 64, 128, 3), np.uint8))


def test_replace_models_repacks_and_drops_graphs(rec):
    """replace_models swaps the models in, packs K1 anew (for packed input
    still at 1/255) and drops every captured graph."""
    rec._graphs[(0,)] = object()
    front = rec._front
    rec.replace_models(plate_model=rec.plate_model)
    assert rec._graphs == {}
    assert rec._front is not front
    assert rec._front.input_scale == (1.0 / 255.0 if rec.cfg.packed_input
                                      else 1.0)
    for k in ("mma", "bias"):
        assert torch.equal(rec._front[k], front[k])


# ---------------------------------------------------------------- card
BATCH = 8
FRAME_HW = (720, 1280)
DET_HW = (736, 1280)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal_on_card(a, b):
    for k in a:
        if isinstance(a[k], dict):
            _equal_on_card(a[k], b[k])
        elif a[k] is not None:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_kw", [{}, {"fused_mid": True},
                                    {"packed_input": True},
                                    {"int8_detector": True},
                                    {"lazy_decode": False}],
                         ids=["default", "fused_mid", "packed", "int8",
                              "eager_decode"])
def test_graph_step_equals_eager_step_on_card(cfg_kw):
    """The production configuration at batch 8 on 720p frames: the graph's
    replays give the eager step's outputs bit for bit, on two batches of
    frames (the second through the same graph), a returned output is not
    changed by the next replay, and each replay adds the kernels the graph
    holds to their launch counts."""
    dev = _card()
    rec = profile_stages.build_recognizer(dev, **cfg_kw)
    assert rec.cfg.freeze_params
    a, b = synth_frames(BATCH, FRAME_HW, 0), synth_frames(BATCH, FRAME_HW, 1)
    first = rec.step_raw(a)
    kept = to_host(first)
    assert len(rec._graphs) == 1
    held = next(iter(rec._graphs.values())).launches
    assert sum(held) >= 2, held
    n_u8 = kf.yolo_front.launches_u8
    second = rec.step_raw(b)
    torch.cuda.synchronize()
    assert kf.yolo_front.launches_u8 - n_u8 == held[1]
    assert len(rec._graphs) == 1
    _assert_same(to_host(first), kept)
    _equal_on_card(first, rec.step_eager(a))
    _equal_on_card(second, rec.step_eager(b))


@pytest.mark.cuda
def test_capture_with_a_pack_that_is_not_bf16_exact_raises():
    """A K1 pack whose weights bf16 would round makes the step raise at its
    first (capturing) call; nothing falls back to the eager step."""
    dev = _card()
    rec = profile_stages.build_recognizer(dev)
    rec._front = kf.FrontPacked(dict(rec._front), False, rec._front.dtype)
    with pytest.raises(ValueError):
        rec.step_raw(synth_frames(2, FRAME_HW, 0))
    assert rec._graphs == {}
