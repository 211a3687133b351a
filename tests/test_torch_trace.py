"""The served path's own measurements on the CPU (``utils/observability.py``,
``serve/server.py``, ``pipeline/recognizer.py``): with spans on, one
``request`` span and ``queue`` child a request, ``dispatch`` and
``resolve`` with their sub-phases a batch, a ``step`` span whose stage
children come in ``DEVICE_STAGES`` order; the counters (queue-wait
histogram, stage sums, collection pauses, graph captures) agree with the
spans; nothing is recorded with spans off; a full ring drops its oldest;
the Chrome-trace export.  On a card (``-m cuda``): the stamp kernel, the
clock calibration and the frozen step's stamps."""

import gc
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.pipeline import recognizer as trec
from lpr_tpu_torch.serve.server import (DISPATCH_PHASES, RESOLVE_PHASES,
                                        InferenceServer, ServeConfig)
from lpr_tpu_torch.utils.observability import (LogHistogram, Tracer,
                                               difference, watch_gc)

MAX_BATCH = 4
N_REQUESTS = 12
TIMEOUT_S = 120


def _recognizer(device="cpu", mesh=None, **cfg):
    char, _, ck = tyolo.load_char_ocr_npz("checkpoints/char_ocr_synth.npz",
                                          device=device)
    kw = dict(det_hw=(64, 128), dtype=torch.float32)
    kw.update(cfg)
    return trec.PlateRecognizer(
        tyolo.load_plate_detector("checkpoints/plate_det640.npz",
                                  device=device),
        char, tlpsr.load_lpsr("checkpoints/lpsr_synth_glare/best_model.npz",
                              device=device),
        trec.PipelineConfig(**kw), char_names=ck.names, device=device,
        mesh=mesh)


def _frames(n, seed=5):
    return np.random.RandomState(seed).randint(0, 256, (n, 60, 120, 3),
                                               dtype=np.uint8)


@pytest.fixture(scope="module")
def rec():
    return _recognizer()


def _serve(rec, n, spans=True, during=None):
    """``n`` requests through a server (spans on or off); ``during()``
    runs while its first batch is in flight.  Returns the stopped
    server."""
    srv = InferenceServer(rec, ServeConfig(max_batch=MAX_BATCH,
                                           max_delay_ms=2.0))
    if spans:
        srv.tracer.enable()
    srv.start()
    try:
        futs = srv.submit_many(_frames(n))
        if during is not None:
            during()
        for f in futs:
            f.result(timeout=TIMEOUT_S)
    finally:
        srv.stop(timeout=TIMEOUT_S)
    return srv


@pytest.fixture(scope="module")
def served(rec):
    return _serve(rec, N_REQUESTS)


def _by(spans, name):
    return [s for s in spans if s.name == name]


def test_each_request_has_one_request_span_and_one_queue_child(served):
    spans = served.tracer.spans()
    reqs, queues = _by(spans, "request"), _by(spans, "queue")
    assert sorted(s.id for s in reqs) == list(range(N_REQUESTS))
    assert sorted(s.id for s in queues) == list(range(N_REQUESTS))
    whole = {s.id: s for s in reqs}
    for q in queues:
        r = whole[q.id]
        assert q.parent == "request" and q.lane == r.lane == "request"
        assert r.t0 == q.t0 <= q.t1 <= r.t1


def test_batch_spans_hold_their_sub_phases(served):
    spans = served.tracer.spans()
    n_batches = served.stats.batches
    for parent, names in (("dispatch", ("staging", "replay",
                                        "host copy start")),
                          ("resolve", RESOLVE_PHASES)):
        outer = {s.id: s for s in _by(spans, parent)}
        assert len(outer) == n_batches
        kids = [s for s in spans if s.parent == parent]
        assert {s.name for s in kids} == set(names)
        for k in kids:
            o = outer[k.id]
            assert o.t0 <= k.t0 <= k.t1 <= o.t1, (parent, k)
    # a request's queue child ends where its batch's dispatch starts
    starts = {s.t0 for s in _by(spans, "dispatch")}
    assert {q.t1 for q in _by(spans, "queue")} <= starts
    assert len({s.id for s in _by(spans, "collect")
                if s.id is not None}) == n_batches


def test_stage_spans_come_in_order_and_tile_the_step(served):
    spans = served.tracer.spans()
    steps = _by(spans, "step")
    assert len(steps) == served.stats.batches
    dispatch = {s.id: s for s in _by(spans, "dispatch")}
    for st in steps:
        stages = [s for s in spans if s.parent == "step" and s.id == st.id]
        assert tuple(s.name for s in stages) == trec.DEVICE_STAGES
        assert stages[0].t0 == st.t0 and stages[-1].t1 == st.t1
        assert all(a.t1 == b.t0 for a, b in zip(stages, stages[1:]))
        assert sum(s.t1 - s.t0 for s in stages) == st.t1 - st.t0
        # the eager step's stamps are host times inside its dispatch
        assert dispatch[st.id].t0 <= st.t0 <= st.t1 <= dispatch[st.id].t1


def test_queue_wait_histogram_counts_every_request(served):
    h = served.stats.queue_wait
    assert sum(h.counts) == N_REQUESTS == served.stats.requests
    waits = sorted((s.t1 - s.t0) / 1e9 for s in _by(served.tracer.spans(),
                                                    "queue"))
    span_p95 = waits[int(np.ceil(0.95 * len(waits))) - 1]
    # the histogram's p95 lies in the spans' p95's bucket or the next
    assert abs(h.index(h.quantile(95)) - h.index(span_p95)) <= 1
    lo, hi = h.bounds(h.index(span_p95))
    assert lo <= span_p95 < hi and hi / lo == pytest.approx(1.04)


def test_stage_sums_equal_the_stage_spans(served):
    spans, st = served.tracer.spans(), served.stats
    assert st.stamped_batches == st.batches
    for name in trec.DEVICE_STAGES:
        total = sum(s.t1 - s.t0 for s in spans
                    if s.name == name and s.parent == "step")
        assert st.stage_s[name] == pytest.approx(total / 1e9, rel=1e-9)
    steps = sum(s.t1 - s.t0 for s in _by(spans, "step"))
    assert st.step_device_s == pytest.approx(steps / 1e9, rel=1e-9)
    assert st.step_device_s == pytest.approx(sum(st.stage_s.values()))
    for name, total in st.resolve_phase_s.items():
        got = sum(s.t1 - s.t0 for s in spans
                  if s.name == name and s.parent == "resolve")
        assert total == pytest.approx(got / 1e9, rel=1e-9), name


def test_spans_off_record_nothing_but_the_counters_move(rec):
    srv = _serve(rec, MAX_BATCH, spans=False)
    assert srv.tracer.spans() == [] and srv.tracer.recorded == 0
    st = srv.stats
    assert sum(st.queue_wait.counts) == MAX_BATCH == st.requests
    assert st.stamped_batches == st.batches >= 1
    assert st.step_device_s > 0 and st.dispatch_phase_s["replay"] > 0
    assert all(st.resolve_phase_s[k] > 0 for k in RESOLVE_PHASES)
    assert set(DISPATCH_PHASES) <= set(st.dispatch_phase_s)


def test_a_full_ring_drops_the_oldest_spans_and_counts_them():
    tr = Tracer(capacity=4)
    tr.record("before", 0, 1)
    assert tr.spans() == []                     # not enabled
    tr.enable()
    for i in range(10):
        tr.record("s", i, i + 1, id=i)
    assert [s.id for s in tr.spans()] == [6, 7, 8, 9]
    assert tr.recorded == 10 and tr.dropped == 6
    tr.disable()
    tr.record("after", 0, 1)
    assert tr.recorded == 10


def test_concurrent_and_reentrant_recording_loses_no_span():
    """Threads record at once (a short switch interval) while a gc hook
    records on whichever thread collects, with a collection at every
    allocation, so the hook also runs inside the tracer's own calls."""
    tr = Tracer(capacity=1 << 20)
    tr.enable()
    n_threads, per_thread = 8, 2000
    remove = watch_gc(lambda g, t0, t1: tr.record("gc", t0, t1, g, lane="gc"))
    old_interval, old_threshold = sys.getswitchinterval(), gc.get_threshold()
    done = []

    def work(k):
        for i in range(per_thread):
            tr.record("s", i, i + 1, id=k)
            if i % 100 == 0:
                tr.spans()
        done.append(k)

    threads = [threading.Thread(target=work, args=(k,), daemon=True)
               for k in range(n_threads)]
    try:
        sys.setswitchinterval(1e-6)
        gc.set_threshold(1)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        gc.set_threshold(*old_threshold)
        sys.setswitchinterval(old_interval)
        remove()
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(n_threads))
    spans = tr.spans()
    ours = [s for s in spans if s.name == "s"]
    assert len(ours) == n_threads * per_thread
    assert tr.recorded == len(spans) and tr.dropped == 0
    assert any(s.name == "gc" for s in spans)


def test_a_forced_collection_is_summed_and_spanned(rec):
    srv = _serve(rec, MAX_BATCH, during=lambda: gc.collect())
    st = srv.stats
    assert st.gc_collections[2] >= 1 and st.gc_pause_s[2] > 0
    gcs = [s for s in srv.tracer.spans() if s.name == "gc"]
    assert any(s.id == 2 and s.lane == "gc" and s.t1 > s.t0 for s in gcs)
    # the hook goes with the server
    n = st.gc_collections[2]
    gc.collect()
    assert st.gc_collections[2] == n


def test_a_second_batch_shape_adds_exactly_one_capture(rec, monkeypatch):
    """The frozen step (run here with a stand-in capture, since a graph
    needs a card) counts one capture a new batch shape."""
    class Replay:
        def replay(self):
            pass

    def capture(frames, packed):
        stamps = torch.zeros((1, 1 + trec.N_STAMPS), dtype=torch.int64)
        return trec._Graph(Replay(), None, None, {"x": torch.ones(1)}, (),
                           stamps)

    monkeypatch.setattr(rec, "_capture", capture)
    monkeypatch.setattr(rec, "_load_inputs", lambda *a: None)
    monkeypatch.setattr(rec, "_graphs", {})
    monkeypatch.setattr(rec, "graph_captures", 0)
    for n in (2, 2, 3, 3, 2):
        rec._frozen_step(_frames(n), None)
    assert rec.graph_captures == 2
    assert [p[0] for p in rec.last_step.phases] == ["staging", "replay",
                                                    "clone"]


def test_sharded_recognizer_keeps_a_stamp_row_a_replica():
    from lpr_tpu_torch.parallel.mesh import make_mesh

    rec = _recognizer(mesh=make_mesh(2))
    srv = _serve(rec, MAX_BATCH)
    st = srv.stats
    assert rec.last_step.stamps.shape == (2, 1 + trec.N_STAMPS)
    assert len(rec.last_step.phases) == 4       # two replicas' two
    steps = [s for s in srv.tracer.spans() if s.name == "step"]
    assert len(steps) == 2 * st.batches
    assert st.step_device_s == pytest.approx(
        sum(s.t1 - s.t0 for s in steps) / 1e9, rel=1e-9)


def test_window_counters_and_chrome_trace(served, tmp_path):
    a = served.stats.counters()
    b = served.stats.counters()
    b["queue_wait"][3] += 2
    d = difference(a, b)
    assert d["requests"] == 0 and d["stage_s"]["LPSR"] == 0
    h = LogHistogram()
    assert h.quantile(50, d["queue_wait"]) == pytest.approx(
        np.sqrt(np.prod(h.bounds(3))))
    json.dumps(a)
    path = tmp_path / "trace.json"
    trace = served.tracer.chrome_trace(str(path))
    assert json.loads(path.read_text()) == trace
    evs = trace["traceEvents"]
    n = len(served.tracer.spans())
    reqs = sum(1 for s in served.tracer.spans() if s.lane == "request")
    assert sum(1 for e in evs if e["ph"] in "Xbe") == n + reqs
    assert {e["args"]["name"] for e in evs if e["ph"] == "M"} == {
        "collector", "device", "gc", "request"}


# ------------------------------------------------------------------ card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stamp_kernel_and_calibration_on_the_card():
    from lpr_tpu_torch.kernels.stamp import calibrate, stamp

    dev = _card()
    offset, err = calibrate(dev)
    assert 0 <= err < 1_000_000                   # under 1 ms
    buf = torch.zeros(3, dtype=torch.int64, device=dev)
    t0 = time.perf_counter_ns()
    for i in range(3):
        stamp(buf, i)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter_ns()
    host = [s - offset for s in buf.tolist()]
    assert host == sorted(host)
    assert t0 - err - 100_000 <= host[0] and host[-1] <= t1 + err + 100_000


@pytest.mark.cuda
def test_frozen_step_stamps_on_the_card():
    dev = _card()
    rec = _recognizer("cuda", dtype=torch.bfloat16)
    frames = _frames(2)
    for _ in range(3):
        t0 = time.perf_counter_ns()
        out = rec.step_raw(frames)
        stamps = trec.start_to_host({"s": rec.last_step.stamps})()["s"]
        t1 = time.perf_counter_ns()
    assert rec.graph_captures == 1
    assert stamps[0, 0] == rec.clock_offset_ns
    host, stages = trec.stamp_times(stamps)
    assert (stages >= 0).all() and stages.sum() > 0
    slack = rec.clock_uncertainty_ns + 100_000
    assert t0 - slack <= host[0, 0] and host[0, -1] <= t1 + slack
    rec.step_raw(_frames(3))
    assert rec.graph_captures == 2
    assert set(out) == {"plate_boxes", "plate_scores", "plate_classes",
                        "plate_valid", "is_long", "sr", "chars_orig",
                        "chars_sr"}
    del dev


@pytest.mark.cuda
def test_eager_step_stamps_on_the_card():
    """Without freeze_params the stamps are kernels on the card as well,
    so the stage times are the card's, on the clock calibrated at the
    first step."""
    dev = _card()
    rec = _recognizer("cuda", dtype=torch.bfloat16, freeze_params=False)
    frames = _frames(2)
    for _ in range(2):
        t0 = time.perf_counter_ns()
        rec.step_raw(frames)
        stamps = trec.start_to_host({"s": rec.last_step.stamps})()["s"]
        t1 = time.perf_counter_ns()
    assert rec.last_step.stamps.device.type == dev.type
    assert rec.graph_captures == 0
    assert stamps[0, 0] == rec.clock_offset_ns
    host, stages = trec.stamp_times(stamps)
    assert (stages >= 0).all() and stages.sum() > 0
    slack = rec.clock_uncertainty_ns + 100_000
    assert t0 - slack <= host[0, 0] and host[0, -1] <= t1 + slack
