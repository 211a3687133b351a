"""The benchmark of lpr_tpu_torch: one cell of ``BENCHMARK.json`` on the
card(s) of this machine.

    python3 lprbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  A cell is a configuration
(``lprbench/configs/<config>.json``: frame size, detector geometry,
checkpoints, the served pipeline's settings), a traffic mix
(``lprbench/traffic/<mix>.json``, driven by ``lprbench/load.py``) and the
cell's own parameters (``lprbench/cells/<cell>.json``, such as an open
loop's fixed rate).  The program under test is the port's served path:
``InferenceServer`` around ``PlateRecognizer`` with its frozen step (one
CUDA graph replay a batch).

Set-up (``setup_s``, from the start of this process): the port's imports
and kernel libraries (built once into ``build/lpr_tpu_torch/`` inside the
checkout), the checkpoints, the frames (from ``--seed``), the server, and
one batch through it, which captures the step's graph at the served batch
shape.  Then the mix runs for its ramp and ``--seconds`` of window.  With
``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` the per-layer metrics of ``lprbench/metrics/<name>.py``: the
host's and the server's counters read over that window, untraced, and the
device's read from a profiler trace of a second window that follows it
(``lprbench/trace.py``).  After the windows, with the device's
peak memory read and the program freed, a sample of the window's answers
drawn from the seed is judged against the plain float32 reference
(``lprbench/check.py``); each number compared is printed beside its limit
on the last lines of standard error and under ``check``, the last key of
the result line, which is the last line of standard output.

Exits 2 without a result when no card (or too few) is present, and 3 when
the process has loaded JAX, Flax or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lpr_tpu")
# Build and kernel caches at fixed paths inside the checkout (the port's
# kernels already build into build/lpr_tpu_torch/ there).
# The traced window's longest length: some hundreds of served steps.
TRACE_SECONDS = 10.0
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(manifest: dict, name: str):
    """(cell entry, configuration, traffic mix, cell parameters, limits)
    of workload ``name``, each from its own file."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    cfg = load_json(ROOT / conf["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    own = HERE / "cells" / f"{name}.json"
    params = load_json(own) if own.exists() else {}
    limits = load_json(HERE / "limits" / f"{cfg['name']}.json")
    return cell, cfg, mix, params, limits


def pipeline_config(cfg: dict, **changes):
    """The port's ``PipelineConfig`` of a configuration file."""
    import torch

    from lpr_tpu_torch.pipeline.recognizer import PipelineConfig

    p = dict(cfg["pipeline"], **changes)
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in p.items()
          if k in PipelineConfig.__dataclass_fields__}
    kw["dtype"] = getattr(torch, p["dtype"])
    return PipelineConfig(**kw)


def build_program(cfg: dict, device, **changes):
    """The port's recognizer on the configuration's checkpoints."""
    from lpr_tpu_torch.models.lpsr import load_lpsr
    from lpr_tpu_torch.models.yolo import (load_char_ocr_npz,
                                           load_plate_detector)
    from lpr_tpu_torch.pipeline.recognizer import PlateRecognizer

    ck = {k: str(ROOT / v) for k, v in cfg["checkpoints"].items()}
    char, _, meta = load_char_ocr_npz(ck["char_ocr"], device)
    return PlateRecognizer(
        load_plate_detector(ck["plate_detector"], device), char,
        load_lpsr(ck["lpsr"], device=device),
        pipeline_config(cfg, **changes), char_names=meta.names,
        device=device)


def start_server(rec, cfg: dict, mix: dict):
    from lpr_tpu_torch.serve.server import InferenceServer, ServeConfig

    s = mix["server"]
    return InferenceServer(rec, ServeConfig(
        max_batch=int(s["max_batch"]), max_delay_ms=float(s["max_delay_ms"]),
        queue_size=int(s["queue_size"]), frame_hw=tuple(cfg["frame_hw"]),
        return_sr=True)).start()


def warm(route, mix: dict) -> None:
    """One full batch through the server: the step's graph is captured at
    the served batch shape, the only one the server runs."""
    n = int(mix["server"]["max_batch"])
    nf = int(mix["distinct_frames"])
    for f in [route.submit(i % nf) for i in range(n)]:
        f.result(600)


def _stats(server) -> dict:
    s = server.stats
    return {"requests": s.requests, "batches": s.batches,
            "dispatch_s": s.dispatch_s, "collect_s": s.collect_s,
            "resolve_s": s.resolve_s}


class Context:
    """What a per-layer reader sees: a window's requests (``run``), the
    server's counters over it (``window_stats``) and the trace's reduction
    (``slice``)."""

    def __init__(self, run, window_stats, slice_, cfg, mix, peaks):
        self.run, self.window_stats, self.slice = run, window_stats, slice_
        self.cfg, self.mix, self.peaks = cfg, mix, peaks

    def roofline_pct(self, kernel: str, work):
        """The kernel's bound at the peaks over its mean device time a
        call in the traced window, in %; None where the trace saw none."""
        if self.slice is None:
            return None
        t, n = self.slice.op_time(kernel)
        if not n or t <= 0:
            return None
        flops, nbytes = work
        bound = max(flops / self.peaks["bf16_flops"],
                    nbytes / self.peaks["hbm_bytes_s"])
        return 100.0 * bound / (t / n)


def _reader(name: str):
    """``metrics/<name>.py``, or for a name split by its cells' end-to-end
    metric (``dispatch_ms.tput``) the file of the name before the suffix."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"lprbench.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_names(manifest: dict, cell: dict, e2e: list) -> list:
    out = []
    for m in manifest["per_layer"]:
        ws = m.get("workloads")
        if ws is not None and cell["name"] not in ws:
            continue
        if ws is None and m["moves"] not in e2e:
            continue
        out.append(m)
    return out


def e2e_names(manifest: dict, cell: dict) -> list:
    return [m["name"] for m in manifest["end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def percentile(xs, q: float) -> float:
    """The q-th percentile (linear interpolation) of xs, inf counted."""
    import numpy as np

    xs = sorted(xs)
    if any(math.isinf(x) for x in xs):
        pos = q / 100.0 * (len(xs) - 1)
        lo = int(math.floor(pos))
        if math.isinf(xs[min(lo + 1, len(xs) - 1)]):
            return math.inf
    return float(np.percentile(xs, q))


def run_cell(manifest: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = T_START,
             cfg_changes: dict = None, mix_changes: dict = None,
             program=None) -> dict:
    """One run of cell ``name``; returns the result line's object (without
    checking for a card).  ``cfg_changes`` and ``mix_changes``
    (configuration and traffic keys) and ``program`` (a function of
    (configuration, device) giving a recognizer) let the tests run it
    small on the CPU and with faults.

    With ``trace`` the mix runs twice: the window of ``seconds``
    untraced, from which the per-layer metrics of the host and the
    server's counters are read, and then, with the server idle, the
    profiler started and the mix run again for a traced window of at most
    ``TRACE_SECONDS``, from which the device's metrics are read."""
    import numpy as np
    import torch

    from lprbench import check, load
    from lprbench.frames import synth_frames
    from lprbench.trace import Spans, Tracer, breakdown

    cell, cfg, mix, params, limits = cell_files(manifest, name)
    cfg = dict(cfg, **(cfg_changes or {}))
    mix = dict(mix, **(mix_changes or {}))
    peaks = load_json(HERE / "peaks.json")
    rate = params.get("rate_fps")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    rec = (program or build_program)(cfg, dev)
    frames = synth_frames(int(mix["distinct_frames"]),
                          tuple(cfg["frame_hw"]), seed % 2**32)
    server = start_server(rec, cfg, mix)
    route = load.route(mix, server, frames)
    tracer, windows, stats = None, [], []

    def counters(tracer=None):
        marks = []

        def during(t0, t1):
            for t in (t0, t1):
                time.sleep(max(0.0, t - time.perf_counter()))
                marks.append(_stats(server))
                if tracer is not None:
                    tracer.mark()
        stats.append(marks)
        return during

    try:
        warm(route, mix)
        if on_card:
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_start
        windows.append(load.drive(route, mix, seconds, seed, rate,
                                  counters()))
        if trace and on_card:
            spans = Spans()
            spans.wrap(server)
            tracer = Tracer(spans)
            tracer.start()
            windows.append(load.drive(route, mix,
                                      min(seconds, TRACE_SECONDS), seed,
                                      rate, counters(tracer)))
    finally:
        server.stop()
    sl = tracer.stop() if tracer is not None else None
    counts = [{k: b[k] - a[k] for k in a} for a, b in stats]
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    run = windows[0]
    attempted = [r for w in windows for r in w.in_window("due")]
    failed = [r for r in attempted if not r.answered()]
    e2e = e2e_names(manifest, cell)
    metrics, notes = {}, []
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"]
             + manifest["per_layer"]}
    if not trace:
        if "frames_per_s" in e2e:
            done = [r for r in run.requests
                    if r.answered() and run.t0 <= r.done < run.t1]
            metrics["frames_per_s"] = len(done) / (run.t1 - run.t0)
        if "latency_p95_ms" in e2e:
            lat = [1e3 * (r.done - r.due) if r.answered() else math.inf
                   for r in run.in_window("due")]
            metrics["latency_p95_ms"] = percentile(lat, 95)
            notes.append(f"latency ms: median {percentile(lat, 50)!r}, "
                         f"p95 {metrics['latency_p95_ms']!r}, samples "
                         f"{len(lat)}, failed {len(failed)}")
        metrics["setup_s"] = setup_s
    else:
        ctxs = [Context(w, c, sl, cfg, mix, peaks)
                for w, c in zip(windows, counts)]
        for m in per_layer_names(manifest, cell, e2e):
            device_side = m["source"] == "device_trace"
            ctx = ctxs[-1] if device_side else ctxs[0]
            v = _reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = float(v)
            if not device_side and len(ctxs) > 1:
                notes.append(f"{m['name']}: untraced {v!r}, traced "
                             f"{_reader(m['name'])(ctxs[1])!r}")
    answered = [r for r in attempted if r.answered()]
    picked = check.sample(answered, int(mix["check_requests"]), seed)
    served = [(r.frame, r.result) for r in picked]
    n_attempted, n_failed = len(attempted), len(failed)
    del rec, server, route, run, windows, answered, attempted, picked
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from lprbench.ref.pipeline import Reference

    ref = Reference({"pipeline": cfg["pipeline"],
                     "checkpoints": {k: str(ROOT / v) for k, v in
                                     cfg["checkpoints"].items()}}, dev)
    numbers = (check.judge(served, frames, ref, limits) if served
               else {k: math.inf for k in limits})
    out = {"correct": bool(served) and check.verdict(numbers, limits,
                                                      n_failed),
           "attempted": n_attempted, "failed": n_failed,
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in metrics.items()},
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name(dev) if on_card
                               else "cpu"),
                      "count": int(cell["chips"]),
                      "memory_peak_bytes": peak}}
    if sl is not None:
        out["device"]["busy_s"] = sl.busy_s
        out["device"]["window_s"] = sl.window_s
        out["breakdown"] = breakdown(sl)
        notes.append(f"trace: window {sl.window_s!r} s, device events "
                     f"{sl.device_events_inside} of {sl.device_events} "
                     f"inside, busy {sl.busy_s!r} s")
    out["check"] = {k: {"value": numbers[k], "limit": v}
                    for k, v in limits.items()}
    out["_notes"] = notes
    return out


def loaded_forbidden() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest_path = ROOT / "BENCHMARK.json"
    if not (ROOT / "lpr_tpu_torch").is_dir() or not manifest_path.exists():
        print("lprbench: no lpr_tpu_torch package or BENCHMARK.json beside "
              "lprbench/: run from the root of a checkout of the repo",
              file=sys.stderr)
        return 2
    manifest = load_json(manifest_path)
    cell = {w["name"]: w for w in manifest["workloads"]}.get(args.workload)
    if cell is None:
        print(f"lprbench: unknown workload {args.workload!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"lprbench: the cell needs {cell['chips']} card(s); "
              f"CUDA available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(manifest, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"lprbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for note in out.pop("_notes"):
        print(note, file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
