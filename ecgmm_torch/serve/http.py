"""Serving HTTP transport (port of `ecgmm_tpu/serve/http.py`): the
endpoint handler, /healthz, /stats, /metrics, the landing page, and the
SIGTERM/SIGINT drain (stop accepting, finish in-flight requests, exit).
Endpoint contract: `Groove/components/SubmitButton.tsx:35-48` /
`Groove/app/(tabs)/ResultScreen.tsx:26-56`.

    python -m ecgmm_torch.serve.api --synthetic                # the card
    python -m ecgmm_torch.serve.api --synthetic --device cpu --port 8080

Uploads are decoded by the port's own decoder (`serve/imdecode.py`), not
Pillow.
"""

from __future__ import annotations

import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ecgmm_torch.serve import digitize as digitize_mod
from ecgmm_torch.serve.imdecode import decode_upload
from ecgmm_torch.parallel import mesh as meshlib
from ecgmm_torch.serve.pipeline import ServingPipeline
from ecgmm_torch.serve.wire import ENDPOINT, BadRequest, parse_multipart

# Upper bound on accepted request bodies (the app uploads one phone photo
# of a few MB), so a bogus Content-Length cannot make the server allocate
# unbounded memory.
MAX_REQUEST_BYTES = 32 * 1024 * 1024
HEATMAP_FIELD_FORMATS = ("png", "jpeg", "cam")


def make_handler(pipeline: ServingPipeline):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj, code: int = 200):
            self._send(json.dumps(obj).encode(), "application/json", code)

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json({"status": "ok"})
            elif self.path == "/stats":
                self._send_json(pipeline.stats())
            elif self.path == "/metrics":
                self._send(pipeline.metrics().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif self.path in ("/", "/index.html"):
                from ecgmm_torch.serve.client import PAGE

                self._send(PAGE.encode(), "text/html; charset=utf-8")
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != ENDPOINT:
                self.send_error(404)
                return
            try:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    raise BadRequest("invalid Content-Length header")
                if length <= 0:
                    raise BadRequest("empty request body")
                if length > MAX_REQUEST_BYTES:
                    pipeline.record_error()
                    self._send_json(
                        {"error": "request body exceeds "
                                  f"{MAX_REQUEST_BYTES} bytes"},
                        code=413,
                    )
                    return
                body = self.rfile.read(length)
                try:
                    fields = parse_multipart(
                        body, self.headers.get("Content-Type", "")
                    )
                except ValueError as e:
                    raise BadRequest(str(e))
                if "file" not in fields:
                    raise BadRequest("missing multipart field 'file'")
                # applies the EXIF orientation: phone cameras store rotated
                # shots as landscape pixels plus an Orientation tag
                img = decode_upload(fields["file"])
                try:
                    questionnaire = json.loads(
                        fields.get("questionnaire", b"{}").decode()
                    )
                except (UnicodeDecodeError, json.JSONDecodeError):
                    raise BadRequest("questionnaire is not valid JSON")
                if not isinstance(questionnaire, dict):
                    raise BadRequest("questionnaire must be a JSON object")
                try:
                    fmt = fields.get("heatmap_format", b"png").decode()
                except UnicodeDecodeError:
                    raise BadRequest("heatmap_format is not valid UTF-8")
                if fmt not in HEATMAP_FIELD_FORMATS:
                    # reject rather than coerce: a typo like "jpg" must not
                    # silently take the png path
                    raise BadRequest(
                        f"unknown heatmap_format {fmt!r}; "
                        "expected png, jpeg or cam"
                    )
                try:
                    result = pipeline.predict(img, questionnaire,
                                              heatmap_format=fmt)
                except digitize_mod.NoTraceError as e:
                    # a decodable image with no ECG in it is a client
                    # problem, not a server fault
                    raise BadRequest(str(e))
                self._send_json(result)
            except BadRequest as e:
                pipeline.record_error()
                self._send_json({"error": str(e)}, code=400)
            except Exception as e:  # the server keeps running; 500
                traceback.print_exc()
                pipeline.record_error()
                self._send_json({"error": str(e)}, code=500)

    return Handler


class GracefulHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that drains on close: handler threads are
    non-daemon and joined by server_close(), so after shutdown() every
    in-flight request finishes and sends its response before the process
    exits. A peer that never reads its response can stall the drain;
    SIGKILL stays the supervisor's escalation."""

    daemon_threads = False
    block_on_close = True


def install_graceful_shutdown(httpd, pipeline: ServingPipeline):
    """SIGTERM/SIGINT -> stop accepting, let in-flight requests complete,
    then return from serve_forever. Main thread only (CPython's
    signal.signal); returns the handler so tests can drain without a
    signal."""
    import signal as _signal

    def _drain(signum=None, frame=None):
        # shutdown() blocks until the accept loop exits: call it from a
        # helper thread, not inside the loop it waits for
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    _signal.signal(_signal.SIGTERM, _drain)
    _signal.signal(_signal.SIGINT, _drain)
    return _drain


def install_max_requests_recycle(httpd, pipeline: ServingPipeline,
                                 max_requests: int) -> None:
    """Worker recycling: once `max_requests` predictions have been
    served, stop accepting, drain in-flight requests and let the process
    exit 0, so a supervisor restarts it (gunicorn's `max_requests`)."""
    checked = threading.Event()

    def maybe_recycle():
        if checked.is_set():
            return
        if pipeline.stats()["requests"] >= max_requests:
            checked.set()
            print(f"[serve] {max_requests} requests served: graceful "
                  "recycle (drain + exit; supervisor restarts)",
                  flush=True)
            threading.Thread(target=httpd.shutdown, daemon=True).start()

    pipeline.on_request_done = maybe_recycle


def serve(pipeline: ServingPipeline, port: int = 8080,
          background: bool = False, graceful: bool = False,
          max_requests: int = 0) -> ThreadingHTTPServer:
    httpd = GracefulHTTPServer(("0.0.0.0", port), make_handler(pipeline))
    if max_requests > 0:
        install_max_requests_recycle(httpd, pipeline, max_requests)
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
    if graceful:
        install_graceful_shutdown(httpd, pipeline)
    httpd.serve_forever()
    httpd.server_close()  # joins in-flight handler threads (drain)
    pipeline.close_batching()  # after the join: no submitter can race it
    return httpd


def batch_buckets(max_batch: int, n_data: int = 1):
    """The buckets of a batched server: n_data times the powers of two up
    to 16, those that do not exceed max_batch
    (`ecgmm_tpu/serve/http.py:287-300`)."""
    return tuple(n_data * b for b in (1, 2, 4, 8, 16)
                 if n_data * b <= max_batch)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Serve the mobile app's "
                                "endpoint from the PyTorch port.")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--synthetic", action="store_true",
                   help="the demo pipeline (seeded random weights); the "
                        "server always serves it")
    p.add_argument("--bundle", default=None,
                   help="serve an AOT deployment bundle (serve/export.py) "
                        "instead of building the pipeline from model code")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="coalesce concurrent requests for this many ms "
                        "into one bucketed device dispatch (0 = off)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="largest batch bucket to serve; rounded down to a "
                        "power of two up to 16")
    p.add_argument("--max-requests", type=int, default=0,
                   help="gracefully drain and exit 0 after serving this "
                        "many predictions (worker recycling; 0 = never)")
    p.add_argument("--n-data", type=int, default=1,
                   help="devices each batched dispatch is split over "
                        "(mesh serving: a model replica on each of the "
                        "first n visible devices)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    # flag errors fire before the pipeline is built
    if args.n_data > 1 and args.batch_window_ms <= 0:
        p.error("--n-data > 1 needs --batch-window-ms > 0 (mesh serving "
                "splits the batched dispatches)")
    if args.n_data > 1 and args.bundle:
        p.error("--n-data > 1 needs a live model — an AOT bundle is a "
                "fixed single-device program")
    buckets = batch_buckets(args.max_batch, args.n_data)
    if args.batch_window_ms > 0 and not buckets and not args.bundle:
        p.error(f"--max-batch {args.max_batch} admits none of the batch "
                f"buckets {batch_buckets(1 << 30, args.n_data)}")
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; pass "
            "--device cpu to serve on the CPU"
        )
    visible = len(meshlib.visible_devices(args.device))
    if args.n_data > visible:
        # before the pipeline is built: enable_batching's check
        raise ValueError(f"n_data={args.n_data} exceeds the {visible} "
                         "visible device(s)")
    if args.bundle:
        pipeline = ServingPipeline.from_exported(args.bundle,
                                                 device=args.device)
    else:
        pipeline = ServingPipeline.demo(device=args.device)
    if args.batch_window_ms > 0 and args.bundle:
        available = pipeline._exported_buckets
        if available is None:
            p.error("bundle was exported without batch_buckets; re-export "
                    "with --batch-buckets to serve batched")
        buckets = tuple(b for b in available if b <= args.max_batch)
        if not buckets:
            p.error(f"--max-batch {args.max_batch} admits none of the "
                    f"available batch buckets {available}")
    if args.batch_window_ms > 0:
        pipeline.enable_batching(args.batch_window_ms,
                                 max_batch=max(buckets), buckets=buckets,
                                 n_data=args.n_data)
    if not args.no_warmup:
        print("warming up (one request through the whole path)")
        pipeline.warmup()
        pipeline.warmup_batched()
    print(f"serving on :{args.port}{ENDPOINT}", flush=True)
    serve(pipeline, args.port, graceful=True,
          max_requests=args.max_requests)
    print("drained in-flight requests; bye")


if __name__ == "__main__":
    main()
