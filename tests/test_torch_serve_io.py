"""The rest of the port's serving surface on the CPU: file and bytes
ingestion, the device-resident frame pool and the HTTP front end
(lpr_tpu_torch/serve), first with a fake recognizer (the cases of
tests/test_serve.py, ported), then with a small real one whose served
answers must equal its recognize() and the JAX recognizer's."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lpr_tpu_torch import native
from lpr_tpu_torch.ops.image import letterbox_host_plain
from lpr_tpu_torch.pipeline import recognizer as trec
from lpr_tpu_torch.serve.http import HttpFrontend
from lpr_tpu_torch.serve.server import InferenceServer, ServeConfig
from lpr_tpu_torch.tools.synth import png_bytes, write_png

from .test_torch_recognizer import build_pair, synth_frames

TIMEOUT_S = 120


class FakeRecognizer:
    """Stands in for PlateRecognizer: step_raw gives each frame's mean (a
    fingerprint of which frame it was) and the frames as the "sr" leaf;
    records the batch sizes and the frames it was given."""

    def __init__(self, freeze_params=True, packed_input=False, delay=0.01):
        class Cfg:
            pass

        self.cfg = Cfg()
        self.cfg.freeze_params = freeze_params
        self.cfg.packed_input = packed_input
        self.device = torch.device("cpu")
        self.delay = delay
        self.batches, self.seen, self.saw_sr = [], [], None

    def step_raw(self, frames, packed=None):
        fr = torch.as_tensor(np.asarray(frames)) if not isinstance(
            frames, torch.Tensor) else frames
        self.batches.append(int(fr.shape[0]))
        self.seen.append(fr.clone())
        time.sleep(self.delay)
        return {"mean": fr.float().mean(dim=(1, 2, 3)), "sr": fr.float()}

    def assemble(self, out):
        self.saw_sr = "sr" in out
        return [[{"box": [0, 0, 1, 1], "score": 0.9, "mean": float(m),
                  "text": f"M{float(m):.0f}", "text_sr": "S", "sr": None}]
                for m in out["mean"]]


def _full(v, hw=(16, 32)):
    return np.full((*hw, 3), v, np.uint8)


def test_server_file_ingestion(tmp_path):
    """submit_path/submit_paths/submit_bytes: JPEG and PNG files decoded
    and letterboxed on the decode threads into the dynamic-batching queue;
    undecodable bytes fail their future, not the server."""
    rec = FakeRecognizer()
    paths = []
    for i in range(6):
        p = tmp_path / f"f{i}.{'jpg' if i % 2 else 'png'}"
        Image.fromarray(_full(40 * i, (30, 60))).save(p, quality=90)
        paths.append(str(p))
    cfg = ServeConfig(max_batch=4, max_delay_ms=20.0, frame_hw=(16, 32),
                      decode_workers=2)
    with InferenceServer(rec, cfg) as srv:
        assert srv.submit_path(paths[0]).result(TIMEOUT_S)[0]["text"] == "M0"
        outs = [f.result(TIMEOUT_S) for f in srv.submit_paths(paths)]
        assert all(len(o) == 1 for o in outs)
        want = native.load_letterbox_batch(paths, (16, 32))
        assert [o[0]["mean"] for o in outs] == pytest.approx(
            want.reshape(6, -1).mean(1), abs=1e-4)
        data = open(paths[1], "rb").read()
        assert srv.submit_bytes(data).result(TIMEOUT_S)[0]["text"].startswith(
            "M")
        bad = srv.submit_bytes(b"not an image")
        with pytest.raises(ValueError, match="undecodable"):
            bad.result(TIMEOUT_S)
        assert srv.infer(_full(0), TIMEOUT_S)[0]["text"] == "M0"
    assert srv.stats.requests == 9
    assert srv._decoder is None


def test_server_file_ingestion_requires_shape():
    with InferenceServer(FakeRecognizer(), ServeConfig(max_batch=2)) as srv:
        with pytest.raises(ValueError):
            srv.submit_path("/nonexistent.jpg")
        with pytest.raises(ValueError):
            srv.submit_bytes(png_bytes(_full(0)))
        with pytest.raises(ValueError):
            srv.submit_paths(["/nonexistent.jpg"])


def test_submit_bytes_of_another_shape_are_resized_as_pillow_does():
    """An encoded image of another shape is fitted with Pillow's BILINEAR
    and centred on a black canvas, as the JAX server does it."""
    rec = FakeRecognizer()
    img = np.random.RandomState(0).randint(0, 256, (24, 40, 3), np.uint8)
    want = np.zeros((16, 32, 3), np.uint8)     # 40 * 16 / 24 -> 27 wide
    want[:, 2:29] = np.asarray(Image.fromarray(img).resize((27, 16),
                                                           Image.BILINEAR))
    with InferenceServer(rec, ServeConfig(max_batch=1, frame_hw=(16, 32),
                                          max_delay_ms=1.0)) as srv:
        srv.submit_bytes(png_bytes(img)).result(TIMEOUT_S)
    np.testing.assert_array_equal(rec.seen[0][0].numpy(), want)


def test_http_frontend():
    with InferenceServer(FakeRecognizer(), ServeConfig(
            max_batch=2, max_delay_ms=1.0)) as srv:
        fe = HttpFrontend(srv, port=0).start()
        try:
            url = f"http://127.0.0.1:{fe.port}"
            with urllib.request.urlopen(url + "/v2/health/ready",
                                        timeout=TIMEOUT_S) as r:
                assert r.status == 200 and r.read() == b"READY"
            buf = io.BytesIO()
            np.save(buf, _full(0, (8, 8)))
            req = urllib.request.Request(url + "/v2/models/pipeline/infer",
                                         data=buf.getvalue())
            with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
                out = json.loads(r.read())
            assert out[0]["text"] == "M0"
            assert "sr" not in out[0]
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(url + "/v2/nothing", timeout=TIMEOUT_S)
            assert e.value.code == 404
        finally:
            fe.stop()


def test_http_infer_batch_and_stats_routes():
    with InferenceServer(FakeRecognizer(), ServeConfig(
            max_batch=4, max_delay_ms=5.0)) as srv:
        fe = HttpFrontend(srv, port=0).start()
        try:
            url = f"http://127.0.0.1:{fe.port}"
            buf = io.BytesIO()
            np.save(buf, np.stack([_full(v, (8, 8)) for v in (0, 10, 20)]))
            req = urllib.request.Request(
                url + "/v2/models/pipeline/infer_batch", data=buf.getvalue())
            with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
                out = json.loads(r.read())
            assert [o[0]["text"] for o in out] == ["M0", "M10", "M20"]
            with urllib.request.urlopen(url + "/v2/stats",
                                        timeout=TIMEOUT_S) as r:
                stats = json.loads(r.read())
            assert stats["requests"] == 3 and "latency_ms_p99" in stats
            # a wrong rank, a pickled object and a frame of another shape
            # each get 400 with the message; the server keeps serving
            bodies = []
            for arr in (_full(0, (8, 8)), np.array([{"a": 1}], object)):
                b = io.BytesIO()
                np.save(b, arr, allow_pickle=True)
                bodies.append(b.getvalue())
            for body in bodies:
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(urllib.request.Request(
                        url + "/v2/models/pipeline/infer_batch", data=body),
                        timeout=TIMEOUT_S)
                assert e.value.code == 400 and e.value.read()
            b = io.BytesIO()
            np.save(b, _full(0, (9, 8)))
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(
                    url + "/v2/models/pipeline/infer", data=b.getvalue()),
                    timeout=TIMEOUT_S)
            assert e.value.code == 400 and b"served shape" in e.value.read()
        finally:
            fe.stop()


def test_server_device_pool_ref_mode():
    """preload() puts the pool on the device; submit_ref() routes each
    index to its frame; submit() is refused in ref mode; an index out of
    range raises at submit time; batches are padded; a pool of another
    shape than the served one is refused."""
    rec = FakeRecognizer()
    with InferenceServer(rec, ServeConfig(max_batch=4,
                                          max_delay_ms=20.0)) as srv:
        pool = np.stack([_full(10 * i, (8, 8)) for i in range(6)])
        assert srv.preload(pool) == 6
        assert srv._pool["frames"].device == rec.device
        outs = [f.result(TIMEOUT_S) for f in
                [srv.submit_ref(i) for i in [3, 0, 5, 1]]]
        assert [o[0]["mean"] for o in outs] == [30.0, 0.0, 50.0, 10.0]
        with pytest.raises(ValueError):
            srv.submit(pool[0])
        with pytest.raises(IndexError):
            srv.submit_ref(6)
        with pytest.raises(IndexError):
            srv.submit_ref(-1)
        assert set(rec.batches) == {4}
        with pytest.raises(ValueError):
            srv.preload(np.zeros((2, 4, 4, 3), np.uint8))
    assert srv.stats.requests == 4


def test_server_pool_pads_with_the_last_index():
    rec = FakeRecognizer()
    with InferenceServer(rec, ServeConfig(max_batch=4,
                                          max_delay_ms=1.0)) as srv:
        srv.preload(np.stack([_full(10 * i, (8, 8)) for i in range(3)]))
        srv.infer_ref(2, TIMEOUT_S)
    means = rec.seen[0].float().mean(dim=(1, 2, 3)).tolist()
    assert means == [20.0] * 4


def test_server_pool_requires_frozen_params():
    with InferenceServer(FakeRecognizer(freeze_params=False),
                         ServeConfig(max_batch=2)) as srv:
        with pytest.raises(ValueError):
            srv.preload(np.zeros((2, 8, 8, 3), np.uint8))
        with pytest.raises(ValueError):
            srv.submit_ref(0)


def test_server_return_sr_false_prunes_fetch():
    rec = FakeRecognizer()
    with InferenceServer(rec, ServeConfig(max_batch=2, max_delay_ms=1.0,
                                          return_sr=False)) as srv:
        srv.preload(np.zeros((2, 8, 8, 3), np.uint8))
        assert srv.infer_ref(1, TIMEOUT_S)[0]["text"] == "M0"
    assert rec.saw_sr is False
    rec2 = FakeRecognizer()
    with InferenceServer(rec2, ServeConfig(max_batch=2,
                                           max_delay_ms=1.0)) as srv:
        srv.preload(np.zeros((2, 8, 8, 3), np.uint8))
        srv.infer_ref(0, TIMEOUT_S)
    assert rec2.saw_sr is True


def test_stop_shuts_the_decode_pool_and_leaves_no_thread(tmp_path):
    before = set(threading.enumerate())
    p = tmp_path / "f.png"
    write_png(p, _full(3, (16, 32)))
    srv = InferenceServer(FakeRecognizer(), ServeConfig(
        max_batch=2, max_delay_ms=1.0, frame_hw=(16, 32))).start()
    futs = [srv.submit_path(str(p)) for _ in range(3)]
    srv.stop(timeout=TIMEOUT_S)
    for f in futs:   # each answered or failed by stop(), none left pending
        assert f.done() or f.exception(timeout=TIMEOUT_S) is not None
    assert srv._decoder is None and not srv._thread.is_alive()
    left = [t for t in threading.enumerate() if t not in before]
    assert not [t for t in left if t.is_alive() and not t.daemon], left


# ------------------------------------------------------- real recognizer
DET_HW = (192, 320)
FRAME_HW = (180, 320)


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port recognizer at det 192x320 (float32) and two
    180x320 frames with rendered plates, with the JAX answers."""
    jr, tr = build_pair(DET_HW)
    frames = synth_frames(2, FRAME_HW, seed=3)
    jax_res = jr.assemble(jax.device_get(jr.step_raw(jnp.asarray(frames))))
    return tr, frames, jax_res


def _key(res):
    return [(p["class_id"], p["text"], p["text_sr"]) for p in res]


def _same(got, want, box_atol):
    assert [_key(r) for r in got] == [_key(r) for r in want]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a["box"], b["box"], rtol=0,
                                       atol=box_atol)


def test_served_files_pool_and_http_equal_recognize_and_jax(pair, tmp_path):
    """Through submit_path, submit_paths, submit_bytes, the device pool and
    HTTP the small real recognizer answers what its recognize() answers
    (boxes within 1e-3 px) and what the JAX recognizer answers (strings
    identical, boxes within 0.5 px)."""
    tr, frames, jax_res = pair
    want = tr.recognize(frames)
    assert sum(len(r) for r in want) >= 2
    _same(want, jax_res, 0.5)
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"f{i}.png"))
        write_png(paths[-1], f)
    cfg = ServeConfig(max_batch=2, max_delay_ms=200.0, frame_hw=FRAME_HW)
    with InferenceServer(tr, cfg) as srv:
        _same([srv.submit_path(p).result(TIMEOUT_S) for p in paths], want,
              1e-3)
        _same([f.result(TIMEOUT_S) for f in srv.submit_paths(paths)], want,
              1e-3)
        _same([srv.submit_bytes(png_bytes(f)).result(TIMEOUT_S)
               for f in frames], want, 1e-3)
        fe = HttpFrontend(srv, port=0).start()
        try:
            buf = io.BytesIO()
            np.save(buf, frames)
            req = urllib.request.Request(
                f"http://127.0.0.1:{fe.port}/v2/models/pipeline/infer_batch",
                data=buf.getvalue())
            with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
                _same(json.loads(r.read()), want, 1e-3)
        finally:
            fe.stop()
    with InferenceServer(tr, ServeConfig(max_batch=2,
                                         max_delay_ms=200.0)) as srv:
        srv.preload(frames)
        _same([f.result(TIMEOUT_S) for f in
               [srv.submit_ref(0), srv.submit_ref(1)]], want, 1e-3)
        _same([srv.infer_ref(1, TIMEOUT_S)], want[1:], 1e-3)


def test_packed_pool_and_pinned_letterbox_give_the_same_outputs():
    """With packed_input: step_raw letterboxing the frames itself (through
    the C letterbox) gives what it gives on letterbox_host_plain's bytes,
    bit for bit; the packed pool, which holds its own letterbox, answers
    what recognize() answers."""
    _, tr = build_pair(DET_HW)
    pk = trec.PlateRecognizer(tr.plate_model, tr.char_model, tr.lpsr_model,
                              trec.PipelineConfig(det_hw=DET_HW,
                                                  dtype=torch.float32,
                                                  packed_input=True),
                              char_names=tr.char_names, device="cpu")
    frames = synth_frames(2, FRAME_HW, seed=3)
    a = trec.to_host(pk.step_raw(frames))
    b = trec.to_host(pk.step_raw(frames, letterbox_host_plain(frames,
                                                              DET_HW)))
    for k in ("plate_boxes", "plate_valid", "sr"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(a["chars_sr"]["classes"],
                                  b["chars_sr"]["classes"])
    want = pk.assemble(a)
    with InferenceServer(pk, ServeConfig(max_batch=2,
                                         max_delay_ms=200.0)) as srv:
        srv.preload(frames)
        assert "packed" in srv._pool
        got = [f.result(TIMEOUT_S) for f in
               [srv.submit_ref(0), srv.submit_ref(1)]]
    _same(got, want, 1e-3)


def test_step_takes_a_list_of_frames_and_start_to_host_gives_to_host():
    """The server hands step_raw its batch as a list of frames (no stacked
    copy); the outputs equal those of the stacked batch, and
    start_to_host's fetch gives what to_host gives."""
    _, tr = build_pair(DET_HW)
    frames = synth_frames(2, FRAME_HW, seed=3)
    ref = trec.to_host(tr.step_raw(frames))
    got = trec.start_to_host(tr.step_raw([frames[0], frames[1]]))()
    for k in ("plate_boxes", "plate_valid", "sr"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["chars_sr"]["classes"],
                                  ref["chars_sr"]["classes"])


# ---------------------------------------------------------------- card
@pytest.mark.cuda
def test_pinned_letterbox_step_equals_plain_letterbox_on_card():
    """On a card with packed_input: the frozen step, whose host letterbox
    writes straight into the pinned staging buffer, gives bit for bit what
    it gives on letterbox_host_plain's bytes, over several steps (the two
    pinned buffers in turns)."""
    from lpr_tpu_torch.tools import profile_stages
    from lpr_tpu_torch.tools.synth import synth_frames as np_frames

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec = profile_stages.build_recognizer(torch.device("cuda"),
                                          packed_input=True)
    for seed in range(3):
        frames = np_frames(8, (720, 1280), seed)
        a = rec.step_raw(frames)
        b = rec.step_raw(frames, letterbox_host_plain(frames, (736, 1280)))
        torch.cuda.synchronize()
        for k in ("plate_boxes", "plate_valid", "sr"):
            assert torch.equal(a[k], b[k]), k


def test_file_ingestion_raises_where_the_decode_library_does_not_build(
        monkeypatch):
    """No fallback: where host_decode cannot build (a machine without
    libjpeg's headers), submit_path/submit_paths/submit_bytes raise in the
    caller with the compiler's message."""
    from lpr_tpu_torch.kernels import _build

    def no_jpeg(name):
        raise RuntimeError(f"g++ failed:\n--- {name}.cc ---\nfatal error: "
                           f"jpeglib.h: No such file or directory")

    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(_build, "host_library", no_jpeg)
    with InferenceServer(FakeRecognizer(), ServeConfig(
            max_batch=2, frame_hw=(16, 32))) as srv:
        for call in (lambda: srv.submit_path("f.png"),
                     lambda: srv.submit_paths(["f.png"]),
                     lambda: srv.submit_bytes(png_bytes(_full(0)))):
            with pytest.raises(RuntimeError, match="jpeglib.h"):
                call()
        assert srv.infer(_full(0), TIMEOUT_S)[0]["text"] == "M0"
