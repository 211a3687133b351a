"""Serving CLI (counterpart of ``lpr_tpu/cli/serve.py``): the dynamic-
batching pipeline server behind the HTTP front end (the reference deploys
Triton + ``inference/triton_run.py``).

    python -m lpr_tpu_torch.cli.serve --d-weights checkpoints/plate_det640.npz \\
        --r-weights checkpoints/char_ocr_synth.npz \\
        --sr-weights checkpoints/lpsr_synth_glare/best_model.npz --port 8000

POST an ``.npy`` RGB frame to ``/v2/models/pipeline/infer``; Ctrl-C
(SIGINT) stops the front end and the server.  ``--port 0`` takes a free
port, printed on the first line.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve the plate pipeline")
    p.add_argument("--r-weights", required=True)
    p.add_argument("--sr-weights", required=True)
    p.add_argument("--d-weights", default=None)
    p.add_argument("--imgsz-det", type=int, default=1280)
    p.add_argument("--d-conf", type=float, default=0.4)   # triton_run.py:167
    p.add_argument("--r-conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)     # triton_run.py:169
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)      # Triton HTTP port
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from lpr_tpu_torch.cli.run import build_recognizer
    from lpr_tpu_torch.serve.http import HttpFrontend
    from lpr_tpu_torch.serve.server import InferenceServer, ServeConfig

    rec = build_recognizer(args)
    srv = InferenceServer(
        rec, ServeConfig(max_batch=args.max_batch,
                         max_delay_ms=args.max_delay_ms)).start()
    fe = None
    try:
        fe = HttpFrontend(srv, args.host, args.port).start()
        print(f"serving on http://{args.host}:{fe.port} "
              f"(POST /v2/models/pipeline/infer with an .npy RGB frame)",
              flush=True)
        while True:
            time.sleep(30)
            s = srv.stats
            print(f"requests {s.requests} batches {s.batches} "
                  f"mean-batch {s.mean_batch:.2f} "
                  f"mean-latency {s.mean_latency_ms:.1f} ms", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        if fe is not None:
            fe.stop()
        srv.stop()
    return 0


if __name__ == "__main__":
    main()
