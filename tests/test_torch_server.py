"""The port's dynamic-batching server on the CPU: it answers every request
with what the recognizer returns for the same frame, and stops cleanly."""

import threading

import numpy as np
import pytest
import torch

from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.pipeline import recognizer as trec
from lpr_tpu_torch.serve.server import InferenceServer, ServeConfig

MAX_BATCH = 4
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def rec():
    char, names = tyolo.load_char_ocr_npz("checkpoints/char_ocr_synth.npz",
                                          device="cpu")
    return trec.PlateRecognizer(
        tyolo.load_plate_detector("checkpoints/plate_det640.npz",
                                  device="cpu"),
        char, tlpsr.load_lpsr("checkpoints/lpsr_synth_glare/best_model.npz",
                              device="cpu"),
        trec.PipelineConfig(det_hw=(64, 128), dtype=torch.float32),
        char_names=names, device="cpu")


def _frames(n):
    return np.random.RandomState(5).randint(0, 256, (n, 60, 120, 3),
                                            dtype=np.uint8)


def _summary(res):
    return [(round(p["score"], 4), p["class_id"], p["text"], p["text_sr"],
             tuple(np.round(p["box"], 2))) for p in res]


def test_server_answers_every_request_like_recognize(rec):
    frames = _frames(2 * MAX_BATCH)
    expected = []
    for s in range(0, len(frames), MAX_BATCH):  # same step batch size
        expected += rec.recognize(frames[s:s + MAX_BATCH])
    srv = InferenceServer(rec, ServeConfig(max_batch=MAX_BATCH,
                                           max_delay_ms=200.0)).start()
    try:
        futs = srv.submit_many(frames)
        got = [f.result(timeout=TIMEOUT_S) for f in futs]
    finally:
        srv.stop(timeout=TIMEOUT_S)
    assert len(got) == len(frames)
    assert [_summary(r) for r in got] == [_summary(r) for r in expected]
    assert srv.stats.requests == len(frames)
    assert srv.stats.batches >= 2
    s = srv.stats.summary()
    assert s["latency_ms_p99"] >= s["latency_ms_p50"] > 0


def test_stop_returns_and_leaves_no_thread(rec):
    before = set(threading.enumerate())
    with InferenceServer(rec, ServeConfig(max_batch=MAX_BATCH,
                                          max_delay_ms=1.0)) as srv:
        assert isinstance(srv.infer(_frames(1)[0], timeout=TIMEOUT_S), list)
        assert srv._thread.daemon
    assert not srv._thread.is_alive()
    left = [t for t in threading.enumerate() if t not in before]
    assert not [t for t in left if not t.daemon], left
    with pytest.raises(RuntimeError):
        srv.submit(_frames(1)[0])


def test_stop_fails_queued_requests_instead_of_leaving_them():
    srv = InferenceServer(object(), ServeConfig(max_batch=2))  # not started
    fut = srv.submit(_frames(1)[0])
    srv.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=1)


def test_return_sr_false_leaves_the_crops_on_the_device(rec):
    with InferenceServer(rec, ServeConfig(max_batch=2, max_delay_ms=1.0,
                                          return_sr=False)) as srv:
        res = srv.infer_many(_frames(2), timeout=TIMEOUT_S)
    assert all(p["sr"] is None for r in res for p in r)
    assert srv.stats.requests == 2


def test_submit_validates_frames(rec):
    srv = InferenceServer(rec, ServeConfig(max_batch=2, frame_hw=(60, 120)))
    with pytest.raises(ValueError):
        srv.submit(np.zeros((60, 121, 3), np.uint8))
    with pytest.raises(ValueError):
        srv.submit(np.zeros((60, 120, 3), np.float32))
    srv.stop()


def test_errors_resolve_the_futures():
    class Boom:
        def step_raw(self, frames):
            raise RuntimeError("boom")

    with InferenceServer(Boom(), ServeConfig(max_batch=2,
                                             max_delay_ms=1.0)) as srv:
        fut = srv.submit(_frames(1)[0])
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=TIMEOUT_S)


def test_summary_rounds_as_the_jax_server_does():
    """ServerStats.summary() rounds mean_batch, throughput_fps and the three
    latencies to 2 decimals, field for field as lpr_tpu's."""
    from lpr_tpu.serve.server import ServerStats as JaxStats
    from lpr_tpu_torch.serve.server import ServerStats

    lat = [0.0123456, 0.0456789, 0.1011121, 0.0333333]
    stats = []
    for cls in (JaxStats, ServerStats):
        s = cls()
        for v in lat:
            s.record(v)
        s.batches, s.frames_padded = 3, 2
        s.started_s -= 3.0     # a throughput with more than 2 decimals
        stats.append(s.summary())
    jax_s, port_s = stats
    assert sorted(port_s) == sorted(jax_s)
    for k in ("requests", "batches", "frames_padded", "mean_batch",
              "latency_ms_mean", "latency_ms_p50", "latency_ms_p99"):
        assert port_s[k] == jax_s[k], k
    assert port_s["mean_batch"] == 1.33 and port_s["latency_ms_p99"] == 101.11
    assert port_s["throughput_fps"] == round(port_s["throughput_fps"], 2)
    assert abs(port_s["throughput_fps"] - jax_s["throughput_fps"]) < 0.05
