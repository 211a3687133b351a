"""``lprbench/tools/program_counters.py``: a window's readings from two
snapshots of the server's counters, the idle gaps with the innermost span
at their middles, the stamps against their kernels, and the wrappers that
it puts around the harness and takes away again."""

import pytest

from lpr_tpu_torch.pipeline.recognizer import DEVICE_STAGES
from lpr_tpu_torch.serve.server import ServerStats
from lpr_tpu_torch.utils.observability import Span
from lprbench import run, trace
from lprbench.tools import program_counters as pc


def test_window_readings_from_two_snapshots():
    st = ServerStats()
    a = st.counters()
    st.requests, st.batches, st.stamped_batches = 30, 3, 3
    st.stage_s = {k: 0.003 for k in DEVICE_STAGES}
    st.step_device_s = 0.003 * len(DEVICE_STAGES)
    st.dispatch_s, st.dispatch_phase_s["staging"] = 0.006, 0.003
    for w in [0.010] * 28 + [0.050] * 2:
        st.queue_wait.add(w)
    st.gc_pause_s[2] = 0.2
    st.gc_collections[2] = 1
    w = pc.window_readings(a, st.counters(), 20.0, 1)
    assert w["mean_batch"] == 10 and w["graph_captures"] == 1
    assert w["stage_ms"] == {k: pytest.approx(1.0) for k in DEVICE_STAGES}
    assert w["geometry_ms"] == pytest.approx(1.0)
    assert w["step_device_ms"] == pytest.approx(len(DEVICE_STAGES))
    assert w["dispatch_ms"] == pytest.approx(2.0)
    assert w["dispatch_phase_ms"]["staging"] == pytest.approx(1.0)
    assert w["queue_wait_p95_ms"] == pytest.approx(50, rel=0.04)
    assert w["gc_pause_pct"] == pytest.approx(1.0)
    assert w["gc_collections"]["2"] == 1
    empty = pc.window_readings(a, a, 1.0, 0)
    assert empty["step_device_ms"] is None and empty["queue_wait_p95_ms"] \
        is None


def test_idle_gaps_and_the_innermost_span():
    gaps = pc.idle_gaps([(10, 20), (15, 30), (60, 70), (95, 120)], 0, 100)
    assert gaps == [(30, 60), (70, 95), (0, 10)]
    spans = [Span("resolve", 0, 100, 1), Span("futures", 40, 50, 1,
                                              "resolve"),
             Span("gc", 42, 48, 2, None, "gc")]
    assert pc.innermost(spans, 45).name == "gc"
    assert pc.innermost(spans, 60).name == "resolve"
    assert pc.innermost(spans, 100) is None


def test_stamps_against_their_kernels():
    stages = [Span(n, 100 + 10 * i, 110 + 10 * i, 7, "step", "device")
              for i, n in enumerate(DEVICE_STAGES)]
    steps = pc.step_stamps(stages + [Span("step", 100, 190, 7)])
    assert steps == [[100 + 10 * i for i in range(len(DEVICE_STAGES) + 1)]]
    late = [s + 5000 for s in steps[0]]
    steps.append(late[:-1] + [late[-1] + 5])    # its last stage 5 ns longer
    # a replay a step, 30 ns and 0 ns before their stamps; a replay far
    # from any batch's stamps (its batch left no spans) is left out
    kernels = [[s - 30 for s in steps[0]], late,
               [9000 + 10 * i for i in range(len(late))]]
    got = pc.stamps_against_kernels(kernels, steps)
    assert got["replays"] == 2 and got["unmatched"] == 1
    assert got["step_rel_diff_max"] == pytest.approx(5 / (late[-1] - late[0]))
    assert got["stamp_minus_kernel_us_min"] == 0
    assert got["stamp_minus_kernel_us_max"] == pytest.approx(0.03)
    assert got["stamp_minus_kernel_us_median"] == pytest.approx(0.0175)
    by_stamps = got["worst_stage_ms_by_stamps"]
    assert by_stamps[:-1] == got["worst_stage_ms_by_kernels"][:-1]
    assert by_stamps[-1] - got["worst_stage_ms_by_kernels"][-1] == \
        pytest.approx(5e-6)
    assert pc.stamps_against_kernels([], steps)["replays"] == 0


def test_the_wrappers_go_on_and_come_off():
    before = (run.start_server, run._stats, trace.Tracer.mark, trace.reduce)

    class Server:
        stats = ServerStats()

        class rec:
            graph_captures = 2

    reading = pc.Reading(spans_always=False)
    undo = reading.install()
    try:
        assert run._stats is not before[1]
        assert run._stats(Server())["batches"] == 0
    finally:
        undo()
    assert (run.start_server, run._stats, trace.Tracer.mark,
            trace.reduce) == before
    assert len(reading.snaps) == 1 and reading.snaps[0][2] == 2
    assert reading.traced([]) is None
