"""The knee of an open-loop cell, found once by a sweep on the card: the
cell's configuration and traffic mix driven at each of a list of total
rates in one process, each for a window after the mix's ramp.

    python3 lprbench/sweep.py --workload lpr720.cams32 --rates 300 400 500
        [--seconds 8] [--seed 4242]

For each rate prints one JSON line: the rate offered, the frames answered a
second in the window, the latency (due to answer) median and 95th
percentile in ms, the backlog (requests due and not answered) at the
window's start and end, and the generator's lag p95.  The knee is the
highest rate whose backlog does not grow over the window; the cell's file
(``lprbench/cells/<cell>.json``) holds 4/5 of it.  Run from the root of a
checkout.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from lprbench import load, run  # noqa: E402


def backlog(requests, t: float) -> int:
    return sum(1 for r in requests
               if r.due <= t and not (r.answered() and r.done <= t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=4242)
    args = ap.parse_args(argv)
    import torch

    from lprbench.frames import synth_frames

    if not torch.cuda.is_available():
        print("sweep: no card", file=sys.stderr)
        return 2
    manifest = run.load_json(ROOT / "BENCHMARK.json")
    cell, cfg, mix, params, limits = run.cell_files(manifest, args.workload)
    dev = torch.device("cuda")
    rec = run.build_program(cfg, dev)
    frames = synth_frames(int(mix["distinct_frames"]),
                          tuple(cfg["frame_hw"]), args.seed)
    server = run.start_server(rec, cfg, mix)
    try:
        route = load.route(mix, server, frames)
        run.warm(route, mix)
        for rate in args.rates:
            r = load.drive(route, mix, args.seconds, args.seed, rate)
            win = [q for q in r.requests if r.t0 <= q.due < r.t1]
            lat = [1e3 * (q.done - q.due) for q in win if q.answered()]
            lags = [q.sent - q.due for q in win]
            done = sum(1 for q in r.requests
                       if q.answered() and r.t0 <= q.done < r.t1)
            print(json.dumps({
                "workload": args.workload, "rate_fps": rate,
                "answered_fps": done / (r.t1 - r.t0),
                "latency_ms_p50": float(np.percentile(lat, 50)),
                "latency_ms_p95": float(np.percentile(lat, 95)),
                "failed": len(win) - len(lat),
                "backlog_start": backlog(r.requests, r.t0),
                "backlog_end": backlog(r.requests, r.t1),
                "gen_lag_ms_p95": 1e3 * float(np.percentile(lags, 95))}),
                flush=True)
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
