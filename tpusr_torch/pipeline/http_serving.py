"""HTTP front end for the micro-batching pipeline server (port of
``tpusr/pipeline/http_serving.py``).

Standard library only (``http.server``): concurrent handler threads submit
single images to one shared ``PipelineServer``, whose worker coalesces them
into fixed-shape device batches, so the micro-batching happens across
simultaneous requests.

Endpoints:
  GET  /healthz     -> {"status": "ok", "config": {...}}
  POST /classify    -> {"class": int, "confidence": float}; body = a PNG or
                       JPEG LR image of the configured LR size
  POST /sr          -> PNG body of the super-resolved image
  POST /classify_sr -> JSON with class/confidence + base64 PNG of the SR

Status codes: 400 for a body that does not decode or an LR image of the
wrong size (refused from its header, before its data is decoded), 504 when the batcher misses ``request_timeout``, 500 for a
pipeline fault, 404 for any other path.

Two things differ from the JAX server. The codec: it decodes any format
OpenCV reads, the port PNG (``pipeline/png.py``) and baseline JPEG
(``pipeline/jpeg.py``, equal to OpenCV's decode), since the card's machine
has no image library; a progressive or other JPEG the decoder refuses, or a
body of another format, gets a 400 that names what it is. The listen backlog: 128, where the standard library's 5 (the
JAX server's) leaves a client beyond the fifth waiting connection to the
kernel's SYN retry, about a second later. Stand it up with ``python -m tpusr_torch.cli serve
--edsr-ckpt ... --vgg16-ckpt ...``.
"""

from __future__ import annotations

import base64
import json
import threading
from concurrent.futures import TimeoutError as FutTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tpusr_torch.pipeline.png import decode_image, encode_png


class _Server(ThreadingHTTPServer):
    request_queue_size = 128     # the listen backlog


def make_http_server(pipeline_server, lr_hw: tuple[int, int],
                     config: dict | None = None, host: str = "127.0.0.1",
                     port: int = 8512, request_timeout: float = 60.0,
                     max_requests: int | None = None):
    """Bind a ThreadingHTTPServer around a STARTED PipelineServer.

    Returns the server object; run it with ``serve_forever()`` (blocking) or
    on a thread. ``config`` is echoed from /healthz for observability.
    ``max_requests`` shuts the server down after that many POSTs to the
    three endpoints have been answered.
    """
    cfg = dict(config or {})
    cfg.update({"lr_h": lr_hw[0], "lr_w": lr_hw[1]})
    served = {"n": 0}
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        # quiet per-request stderr logging; errors still surface as responses
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj: dict):
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._reply_json(200, {"status": "ok", "config": cfg})
            else:
                self._reply_json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path not in ("/classify", "/sr", "/classify_sr"):
                self._reply_json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                self._handle_post()
            finally:
                if max_requests is not None:
                    with lock:
                        served["n"] += 1
                        done = served["n"] >= max_requests
                    if done:
                        # shutdown() from a handler thread is safe: it only
                        # signals the serve_forever loop running elsewhere
                        threading.Thread(target=self.server.shutdown,
                                         daemon=True).start()

        def _handle_post(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                img = decode_image(self.rfile.read(length),
                                   expected_hw=lr_hw)
                if img.shape[:2] != tuple(lr_hw):
                    raise ValueError(f"expected {lr_hw[0]}x{lr_hw[1]} LR "
                                     f"input, got {img.shape[0]}x{img.shape[1]}")
            except Exception as e:  # bad request: undecodable / wrong shape
                self._reply_json(400, {"error": str(e) or "",
                                       "type": type(e).__name__})
                return
            try:
                res = pipeline_server.submit(img).result(
                    timeout=request_timeout)
            except FutTimeout as e:
                # load balancers must see server trouble, not client error:
                # 504 = batcher/pipeline missed the deadline
                self._reply_json(504, {"error": str(e) or "",
                                       "type": type(e).__name__})
                return
            except Exception as e:  # pipeline fault / server stopped -> 500
                self._reply_json(500, {"error": str(e) or "",
                                       "type": type(e).__name__})
                return
            if self.path == "/classify":
                self._reply_json(200, {"class": res["class"],
                                       "confidence": res["confidence"]})
            elif self.path == "/sr":
                self._reply(200, encode_png(res["sr"]), "image/png")
            else:
                self._reply_json(200, {
                    "class": res["class"],
                    "confidence": res["confidence"],
                    "sr_png_base64":
                        base64.b64encode(encode_png(res["sr"])).decode(),
                })

    return _Server((host, port), Handler)
