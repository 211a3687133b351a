"""One run of a benchmark cell with the served path's own counters and
spans read out (``lpr_tpu_torch/utils/observability.py``), as per-layer
readers of them would read them.

    python3 lprbench/tools/program_counters.py --workload <cell>
        --seed <n> --seconds <s> --trace <0|1> [--spans <0|1>]

Run from the root of a checkout, as ``lprbench/run.py``.  The run is
``run.run_cell`` itself; four of the harness's names are wrapped from
here, and no file of the harness is changed:

- ``run.start_server`` keeps the server;
- ``run._stats``, called at each window's two ends, also snapshots
  ``server.stats.counters()`` and the recognizer's ``graph_captures``;
- ``trace.Tracer.mark`` turns the program's spans on for the traced window
  alone (``server.tracer.enable()`` at its first mark, ``disable()`` at
  its second), and reads the host's realtime clock against
  ``perf_counter_ns`` there (the profiler's events are on the realtime
  clock);
- ``trace.reduce`` keeps the profiler's events for the readings below.

``--spans 1`` turns the spans on from the server's start instead: the
tracing's cost is a run with ``--spans 1`` against one with ``--spans 0``.

The last line of standard output is one JSON object: ``result``, the
run's own result line; ``windows``, for each window (the untraced one,
then with ``--trace 1`` the traced one): the stages' device ms a step
(``stage_ms``; ``step_device_ms`` first stamp to last, ``geometry_ms``
the "crop/deskew geometry" stage), the dispatch and resolve sub-phases in
ms a batch, ``queue_wait_p95_ms``, ``gc_pause_pct`` (collection pauses
over the window's length) with the collections by generation, and the
graph captures inside it; and with ``--trace 1`` ``traced``: the ten
longest idle gaps of the card, each with the program's innermost span at
its middle (and the harness's name for it), and the stamps against the
profiler's (CUPTI's) record of the stamp kernels: a replay's step time by
its stamps against the time from its first stamp kernel's start to its
last's, and each stamp, mapped to ``perf_counter_ns``, against its
kernel's start.  Standard error gives the same in short.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[2]
STAMP_KERNEL = "stamp_kernel"
GEOMETRY = "crop/deskew geometry"
N_GAPS = 10


def window_readings(a: dict, b: dict, seconds: float,
                    captures: int) -> dict:
    """The readings of one window from the counters at its ends (``a``,
    ``b``: ``ServerStats.counters()``), its length and the graphs
    captured inside it."""
    from lpr_tpu_torch.utils.observability import LogHistogram, difference

    d = difference(a, b)
    batches, stamped = d["batches"], d["stamped_batches"]

    def per(total, n):
        return 1e3 * total / n if n else None

    p95 = LogHistogram().quantile(95, d["queue_wait"])
    return {
        "seconds": seconds, "requests": d["requests"], "batches": batches,
        "stamped_batches": stamped,
        "mean_batch": d["requests"] / batches if batches else None,
        "stage_ms": {k: per(v, stamped) for k, v in d["stage_s"].items()},
        "step_device_ms": per(d["step_device_s"], stamped),
        "geometry_ms": per(d["stage_s"][GEOMETRY], stamped),
        "collect_ms": per(d["collect_s"], batches),
        "dispatch_ms": per(d["dispatch_s"], batches),
        "resolve_ms": per(d["resolve_s"], batches),
        "dispatch_phase_ms": {k: per(v, batches)
                              for k, v in d["dispatch_phase_s"].items()},
        "resolve_phase_ms": {k: per(v, batches)
                             for k, v in d["resolve_phase_s"].items()},
        "queue_wait_p95_ms": None if p95 is None else 1e3 * p95,
        "gc_pause_pct": 100.0 * sum(d["gc_pause_s"].values()) / seconds,
        "gc_pause_ms": {str(k): 1e3 * v for k, v in d["gc_pause_s"].items()},
        "gc_collections": {str(k): v
                           for k, v in d["gc_collections"].items()},
        "graph_captures": captures,
    }


def idle_gaps(intervals: Sequence[Tuple[int, int]], lo: int, hi: int
              ) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers, longest first
    (the harness's own reduction, ``trace.reduce``, with their times
    kept)."""
    gaps, end = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals
                       if e > lo and s < hi):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def innermost(spans, t: int):
    """The shortest span that holds ``t``, or None."""
    inside = [s for s in spans if s.t0 <= t < s.t1]
    return min(inside, key=lambda s: s.t1 - s.t0) if inside else None


def step_stamps(spans) -> List[List[int]]:
    """Each batch's stamps (``perf_counter_ns``), rebuilt from the device
    spans: a ``step`` span's stage children, in order, give its first
    stamp and the end of each stage.  Sorted by the first stamp."""
    by_batch: Dict[int, list] = {}
    for s in spans:
        if s.parent == "step":
            by_batch.setdefault(s.id, []).append(s)
    out = []
    for stages in by_batch.values():
        stages.sort(key=lambda s: s.t0)
        out.append([stages[0].t0] + [s.t1 for s in stages])
    return sorted(out)


def _nearest(xs: Sequence[int], x: int) -> int:
    """The index of the value of the sorted ``xs`` nearest ``x``."""
    i = bisect.bisect_left(xs, x)
    return min((j for j in (i - 1, i) if 0 <= j < len(xs)),
               key=lambda j: abs(xs[j] - x))


def stamps_against_kernels(replays: Sequence[Sequence[int]],
                           steps: Sequence[Sequence[int]]) -> dict:
    """Each replay's stamp kernel starts (``perf_counter_ns``, one list a
    replay, in order, sorted by the first) against the stamps of its batch
    (sorted likewise): the batch whose first stamp lies nearest the
    replay's first kernel, where that replay is also the one nearest the
    batch (a replay whose batch left no spans, at the window's ends, is
    left out).  Gives the step's time by its stamps against the kernels'
    first-to-last, every stamp against its kernel's start (stamp minus
    start), and the stages of the replay that agrees least, by the stamps
    and by the kernels."""
    if not replays or not steps:
        return {"replays": 0, "unmatched": len(replays)}
    kfirst, sfirst = [k[0] for k in replays], [s[0] for s in steps]
    rel, gaps, worst = [], [], None
    for i, k in enumerate(replays):
        j = _nearest(sfirst, k[0])
        st = steps[j]
        if _nearest(kfirst, st[0]) != i or len(st) != len(k) \
                or k[-1] <= k[0]:
            continue
        r = abs((st[-1] - st[0]) - (k[-1] - k[0])) / (k[-1] - k[0])
        rel.append(r)
        gaps.extend(a - b for a, b in zip(st, k))
        if worst is None or r > worst[0]:
            worst = (r, st, k)
    if not rel:
        return {"replays": 0, "unmatched": len(replays)}
    r, st, k = worst
    return {"replays": len(rel), "unmatched": len(replays) - len(rel),
            "step_rel_diff_median": statistics.median(rel),
            "step_rel_diff_max": max(rel),
            "replays_within_2pct": sum(x <= 0.02 for x in rel),
            "stamp_minus_kernel_us_median": statistics.median(gaps) / 1e3,
            "stamp_minus_kernel_us_min": min(gaps) / 1e3,
            "stamp_minus_kernel_us_max": max(gaps) / 1e3,
            "worst_stage_ms_by_stamps": [(b - a) / 1e6
                                         for a, b in zip(st, st[1:])],
            "worst_stage_ms_by_kernels": [(b - a) / 1e6
                                          for a, b in zip(k, k[1:])]}


class Reading:
    """The wrappers' state over one run."""

    def __init__(self, spans_always: bool):
        self.spans_always = spans_always
        self.server = None
        self.snaps: List[Tuple[float, dict, int]] = []
        self.realtime_minus_perf: List[int] = []
        self.mark_perf_ns: List[int] = []
        self.events = None

    def install(self):
        """Wrap the harness's names; returns the function that unwraps
        them."""
        from lprbench import run, trace

        saved = (run.start_server, run._stats, trace.Tracer.mark,
                 trace.reduce)
        start_server, stats, mark, reduce = saved

        def start_server_(rec, cfg, mix):
            self.server = start_server(rec, cfg, mix)
            if self.spans_always:
                self.server.tracer.enable()
            return self.server

        def stats_(server):
            self.snaps.append((time.perf_counter(), server.stats.counters(),
                               int(server.rec.graph_captures)))
            return stats(server)

        def mark_(tracer):
            mark(tracer)
            self.mark_perf_ns.append(time.perf_counter_ns())
            self.realtime_minus_perf.append(time.time_ns()
                                            - time.perf_counter_ns())
            if self.spans_always:
                return
            if self.server.tracer.enabled:
                self.server.tracer.disable()
            else:
                self.server.tracer.enable()

        def reduce_(prof, out, spans):
            self.events = [
                (e.name(), str(e.device_type()), e.start_ns(),
                 e.start_ns() + e.duration_ns(), e.correlation_id())
                for e in prof.profiler.kineto_results.events()]
            return reduce(prof, out, spans)

        run.start_server, run._stats = start_server_, stats_
        trace.Tracer.mark, trace.reduce = mark_, reduce_

        def uninstall():
            (run.start_server, run._stats, trace.Tracer.mark,
             trace.reduce) = saved
        return uninstall

    def windows(self) -> List[dict]:
        out = []
        for (ta, a, ca), (tb, b, cb) in zip(self.snaps[::2],
                                            self.snaps[1::2]):
            out.append(window_readings(a, b, tb - ta, cb - ca))
        return out

    def traced(self, harness_gaps) -> Optional[dict]:
        """The traced window's gaps and the stamps against the kernels,
        on ``perf_counter_ns`` (the events' realtime clock less the
        offset read at the marks)."""
        from lpr_tpu_torch.pipeline.recognizer import N_STAMPS
        from lprbench.trace import MARK

        if self.events is None or len(self.realtime_minus_perf) != 2:
            return None
        off = round(statistics.mean(self.realtime_minus_perf))
        marks = sorted(s for n, k, s, _, _ in self.events
                       if n == MARK and k.endswith("CPU"))
        dev = [(n, s - off, e - off, c) for n, k, s, e, c in self.events
               if k.endswith("CUDA") and n != MARK]
        if len(marks) != 2:
            return None
        lo, hi = marks[0] - off, marks[1] - off
        spans = self.server.tracer.spans()
        gaps = []
        for (gs, ge), (named, _) in zip(
                idle_gaps([(s, e) for _, s, e, _ in dev], lo, hi)[:N_GAPS],
                list(harness_gaps) + [(None, None)] * N_GAPS):
            sp = innermost(spans, (gs + ge) // 2)
            gaps.append({
                "ms": (ge - gs) / 1e6, "harness": named,
                "span": None if sp is None else sp.name,
                "span_parent": None if sp is None else sp.parent,
                "span_id": None if sp is None else sp.id,
                "span_ms": None if sp is None else (sp.t1 - sp.t0) / 1e6})
        replays: Dict[int, List[int]] = {}
        for n, s, e, c in dev:
            if STAMP_KERNEL in n and lo <= s < hi:
                replays.setdefault(c, []).append(s)
        full = [sorted(v) for v in replays.values() if len(v) == N_STAMPS]
        return {
            "realtime_minus_perf_drift_us":
                (self.realtime_minus_perf[1]
                 - self.realtime_minus_perf[0]) / 1e3,
            "mark_skew_us": [(m - off - p) / 1e3 for m, p in
                             zip(marks, self.mark_perf_ns)],
            "spans": len(spans), "spans_dropped": self.server.tracer.dropped,
            "idle_gaps": gaps,
            "stamps": stamps_against_kernels(sorted(full),
                                             step_stamps(spans)),
        }


def measure(manifest: dict, name: str, seed: int, seconds: float,
            trace: bool, spans_always: bool = False, **kw) -> dict:
    """``run.run_cell`` with the readings (the module's docstring);
    ``kw`` goes to ``run_cell`` (the tests' small CPU runs)."""
    from lprbench import run

    reading = Reading(spans_always)
    uninstall = reading.install()
    try:
        result = run.run_cell(manifest, name, seed, seconds, trace, **kw)
    finally:
        uninstall()
    harness_gaps = (result.get("breakdown") or {}).get("idle_gaps", [])
    return {"result": result, "windows": reading.windows(),
            "traced": reading.traced(harness_gaps)}


def summary(got: dict) -> List[str]:
    lines = []
    for i, w in enumerate(got["windows"]):
        label = "traced" if i else "untraced"
        stages = ", ".join(f"{k} {v!r}" for k, v in w["stage_ms"].items())
        lines += [
            f"{label}: step_device_ms {w['step_device_ms']!r}, geometry_ms "
            f"{w['geometry_ms']!r}, queue_wait_p95_ms "
            f"{w['queue_wait_p95_ms']!r}, gc_pause_pct "
            f"{w['gc_pause_pct']!r}, graph captures {w['graph_captures']}",
            f"{label} stage ms a step: {stages}",
            f"{label} dispatch ms a batch: {w['dispatch_phase_ms']}",
            f"{label} resolve ms a batch: {w['resolve_phase_ms']}"]
    t = got["traced"]
    if t is not None:
        for g in t["idle_gaps"]:
            lines.append(f"gap {g['ms']!r} ms: program {g['span']} "
                         f"({g['span_parent']}, id {g['span_id']}, "
                         f"{g['span_ms']!r} ms), harness {g['harness']}")
        lines.append(f"stamps against kernels: {t['stamps']}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from lprbench import run

    for k, v in run.CACHES.items():
        os.environ[k] = str(ROOT / v)
    import torch

    if not torch.cuda.is_available():
        print("program_counters: needs a CUDA card", file=sys.stderr)
        return 2
    got = measure(run.load_json(ROOT / "BENCHMARK.json"), args.workload,
                  args.seed, args.seconds, bool(args.trace),
                  bool(args.spans))
    for note in got["result"].pop("_notes"):
        print(note, file=sys.stderr)
    for line in summary(got):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
