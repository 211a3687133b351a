"""Minimal HTTP front end for
:class:`lpr_tpu_torch.serve.server.InferenceServer` (counterpart of
``lpr_tpu/serve/http.py``, the same routes and bodies).

- ``GET  /v2/health/ready``                -> 200 ``READY`` while serving
- ``POST /v2/models/pipeline/infer``       -> body: raw ``.npy`` of an
  (H, W, 3) uint8 RGB frame; response: JSON list of plate dicts (box,
  score, class_id, is_long, text, text_sr; the ``sr`` crop stripped)
- ``POST /v2/models/pipeline/infer_batch`` -> body: raw ``.npy`` of a
  (B, H, W, 3) uint8 batch; response: JSON list, one plate list a frame.
  The frames share the dynamic-batching queue with single requests.
- ``GET  /v2/stats``                       -> JSON ``ServerStats.summary()``

A body that does not load (``np.load(allow_pickle=False)``), has the wrong
rank or shape, or that the server refuses gets 400 with the message.
Standard library only; one thread per connection on top of the server's
dispatch loop.  Like the JAX front end it carries no authentication, TLS or
request-size limit: a trusted-network shim, to be fronted by a reverse
proxy that enforces them.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _strip(plates):
    return [{k: v for k, v in p.items() if k != "sr"} for p in plates]


def make_handler(server):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: bytes,
                   content_type: str = "text/plain") -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _json(self, obj) -> None:
            self._reply(200, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/v2/health/ready":
                self._reply(200, b"READY")
            elif self.path == "/v2/stats":
                self._json(server.stats.summary())
            else:
                self._reply(404, b"")

        def do_POST(self):
            single = self.path == "/v2/models/pipeline/infer"
            batched = self.path == "/v2/models/pipeline/infer_batch"
            if not (single or batched):
                self._reply(404, b"")
                return
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                arr = np.asarray(np.load(io.BytesIO(body),
                                         allow_pickle=False), np.uint8)
                if single:
                    out = _strip(server.infer(arr))
                else:
                    if arr.ndim != 4:
                        raise ValueError(f"infer_batch expects (B, H, W, 3), "
                                         f"got {arr.shape}")
                    out = [_strip(r) for r in server.infer_many(arr)]
            except Exception as e:  # a bad request gets 400, not a dead server
                self._reply(400, str(e).encode())
                return
            self._json(out)

    return Handler


class HttpFrontend:
    """A ``ThreadingHTTPServer`` on (host, port) over an
    :class:`~lpr_tpu_torch.serve.server.InferenceServer`; port 0 takes a
    free one (``.port``)."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 8000):
        self.httpd = ThreadingHTTPServer((host, port), make_handler(server))
        self.port = self.httpd.server_address[1]
        self._thread = None

    def start(self) -> "HttpFrontend":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="lpr-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
