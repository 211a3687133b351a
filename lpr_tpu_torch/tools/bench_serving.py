"""Closed-loop serving benchmark of the port: frames/s and request latency
p50/p99 through :class:`~lpr_tpu_torch.serve.server.InferenceServer`
(counterpart of ``tools/bench_serving.py``).

    python -m lpr_tpu_torch.tools.bench_serving [--clients 64] [--frames 20]
        [--max-batch 32] [--max-delay-ms 8] [--frame-hw 720 1280]
        [--det-w 1280] [--dtype bf16] [--http | --files | --pool] [--no-sr]
        [--device cuda]

``--clients`` threads each send ``--frames`` requests back to back (closed
loop: the next after the answer) through one server around the production
recognizer (``lpr_tpu_torch.bench``'s checkpoints and detector geometry,
the step frozen into a CUDA graph).  The frames are made from a seed with
numpy (``tools/synth.py``, at most 8 distinct, client i sends frame
i mod 8).  Modes, as the JAX tool's:

- default (``inproc``): numpy frames through ``InferenceServer.infer``;
- ``--files``: the frames written once as PNG files, each request a path
  through ``submit_path`` (decode and letterbox on the server's decode
  threads).  The JAX tool writes JPEG at quality 90 with PIL; the port has
  no PIL, so this tool writes PNG with ``tools/synth.py``'s writer;
- ``--pool``: the frames preloaded on the device (``preload``), each
  request a pool index (``infer_ref``); as in the JAX tool, this mode's
  recognizer takes ``packed_input``, so the pool also holds the frames'
  letterbox;
- ``--http``: each request an ``.npy`` body POSTed to the HTTP front end
  (``serve/http.py``) on 127.0.0.1.

``--no-sr`` serves with ``return_sr=False``.  One warm-up batch (the graph's
capture) runs before the clock.  Prints the card's name and power limit
(``card: ...``), then one JSON line: ``mode``, ``requests``, ``value`` (the
clients' frames/s: answered requests over the wall time of the loop),
``latency_ms_p50`` / ``_p99`` (the server's, from enqueue to answer),
``mean_batch``, ``batch_ms`` (the loop's wall time over the batches) and
``collector_ms`` (the collector thread's time per batch in its three
parts: collect, dispatch, resolve; ``ServerStats.collect_s`` ...), with
the card under ``gpu``.  On the CPU (``--device
cpu``) no device figure is measured: the run checks the program, and its
host-clock figures are printed under ``cpu_*`` keys with the others null.
Run from the repo root.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

TIMEOUT_S = 600.0
DISTINCT_FRAMES = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--frames", type=int, default=20,
                    help="requests per client (closed loop)")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-delay-ms", type=float, default=8.0)
    ap.add_argument("--frame-hw", type=int, nargs=2, default=(720, 1280))
    ap.add_argument("--det-w", type=int, default=1280)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--http", action="store_true",
                      help="requests as .npy bodies through the HTTP front "
                           "end")
    mode.add_argument("--files", action="store_true",
                      help="requests as PNG paths through submit_path")
    mode.add_argument("--pool", action="store_true",
                      help="requests as indices of a device-resident frame "
                           "pool (preload, infer_ref; packed_input)")
    ap.add_argument("--no-sr", action="store_true",
                    help="ServeConfig.return_sr=False")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from lpr_tpu_torch.bench import det_hw
    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.serve.http import HttpFrontend
    from lpr_tpu_torch.serve.server import (InferenceServer, ServeConfig,
                                            ServerStats)
    from lpr_tpu_torch.tools import _timing
    from lpr_tpu_torch.tools.profile_stages import build_recognizer
    from lpr_tpu_torch.tools.synth import synth_frames, write_png

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    frame_hw = tuple(args.frame_hw)
    hw = det_hw(frame_hw, args.det_w)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]
    rec = build_recognizer(dev, dtype, hw, packed_input=args.pool)
    frames = synth_frames(min(args.clients, DISTINCT_FRAMES), frame_hw,
                          seed=0)
    mode = ("http" if args.http else "pool" if args.pool
            else "files" if args.files else "inproc")

    tmp = tempfile.mkdtemp(prefix="lpr_bench_serving_") if args.files else None
    paths = []
    if tmp is not None:
        for i, f in enumerate(frames):
            paths.append(os.path.join(tmp, f"frame{i}.png"))
            write_png(paths[-1], f)
        print("# files mode: PNG files (the JAX tool writes JPEG at quality "
              "90), decoded by the port's C host decode", file=sys.stderr)

    cfg = ServeConfig(max_batch=args.max_batch,
                      max_delay_ms=args.max_delay_ms,
                      queue_size=4 * args.clients, frame_hw=frame_hw,
                      return_sr=not args.no_sr)
    try:
        with InferenceServer(rec, cfg) as srv:
            if args.pool:
                n_pool = srv.preload(frames)
                warm = [srv.submit_ref(0) for _ in range(args.max_batch)]
            elif args.files:
                warm = srv.submit_paths([paths[0]] * args.max_batch)
            else:
                warm = srv.submit_many(np.stack([frames[0]] * args.max_batch))
            for f in warm:
                f.result(TIMEOUT_S)
            srv.stats = ServerStats()
            fe = HttpFrontend(srv, port=0).start() if args.http else None
            done = []
            errors = []
            lock = threading.Lock()

            def client(cid: int) -> None:
                import urllib.request

                i = cid % len(frames)
                buf = io.BytesIO()
                np.save(buf, frames[i])
                body = buf.getvalue()
                n_ok = 0
                try:
                    for _ in range(args.frames):
                        if fe is not None:
                            req = urllib.request.Request(
                                f"http://127.0.0.1:{fe.port}"
                                f"/v2/models/pipeline/infer", data=body)
                            with urllib.request.urlopen(
                                    req, timeout=TIMEOUT_S) as r:
                                json.loads(r.read())
                        elif args.pool:
                            srv.infer_ref(cid % n_pool, TIMEOUT_S)
                        elif args.files:
                            srv.submit_path(paths[i]).result(TIMEOUT_S)
                        else:
                            srv.infer(frames[i], TIMEOUT_S)
                        n_ok += 1
                except Exception as e:  # reported after the join
                    with lock:
                        errors.append(repr(e))
                with lock:
                    done.append(n_ok)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(args.clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT_S)
            dt = time.perf_counter() - t0
            if fe is not None:
                fe.stop()
            if errors or any(t.is_alive() for t in threads):
                raise RuntimeError(f"clients failed: {errors[:3]}")
            st = srv.stats
            s = st.summary()
            per_batch = {k: 1e3 * getattr(st, f"{k}_s") / max(st.batches, 1)
                         for k in ("collect", "dispatch", "resolve")}
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    total = sum(done)
    measured = {"value": total / dt, "latency_ms_p50": s["latency_ms_p50"],
                "latency_ms_p99": s["latency_ms_p99"],
                "batch_ms": 1e3 * dt / max(s["batches"], 1),
                "collector_ms": per_batch}
    record = {"metric": "serving_frames_per_sec", "unit": "frames/s",
              "mode": mode, "requests": total, "clients": args.clients,
              "frames_per_client": args.frames, "max_batch": args.max_batch,
              "max_delay_ms": args.max_delay_ms,
              "mean_batch": s["mean_batch"], "batches": s["batches"],
              "packed_input": args.pool, "return_sr": not args.no_sr,
              "frame_hw": list(frame_hw), "det_hw": list(hw),
              "gpu": _timing.card(dev)}
    if on_card:
        record.update(measured)
    else:
        record.update({k: None for k in measured})
        record.update({"cpu_frames_per_s": measured["value"],
                       "cpu_latency_ms_p50": s["latency_ms_p50"],
                       "cpu_latency_ms_p99": s["latency_ms_p99"],
                       "cpu_batch_ms": measured["batch_ms"],
                       "cpu_collector_ms": per_batch})
    print(f"card: {record['gpu']}")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
