"""Minimal HTTP serving front end over CodeFuseHandler (port of
api/http_server.py).

A stdlib ThreadingHTTPServer exposes the request/response contract the
handler speaks (the codefuse_example.py JSONL schema):

  POST /predict   body = request_dict JSON
                  -> 200 {"res": ...} on success (the handler's resultMap),
                     500 {"error": traceback} on failure
  GET  /healthz   -> 200 "ok"

Each HTTP request runs on its own thread; with a pooled handler
(``CodeFuseHandler(pool=...)``) concurrent requests interleave mid-flight in
the continuous-batching slot pool.
"""
from __future__ import annotations

import itertools
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def make_server(handler, host: str = "127.0.0.1", port: int = 8080):
    """Build (without starting) a ThreadingHTTPServer bound to the handler;
    port 0 picks a free one (``server_address[1]``)."""
    counter = itertools.count()  # atomic under the GIL

    class _Req(BaseHTTPRequestHandler):
        def _send(self, code: int, payload):
            body = (payload if isinstance(payload, str) else json.dumps(payload)).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 -- http.server API
            if self.path == "/healthz":
                self._send(200, '"ok"')
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                request_dict = json.loads(self.rfile.read(n))
            except Exception as e:  # noqa: BLE001 -- any unreadable body is a 400
                self._send(400, {"error": f"bad request: {e}"})
                return
            code, err, result_map = handler.predict(request_dict, f"http-{next(counter)}")
            if code != 0:
                self._send(500, {"error": err})
            else:
                self._send(200, {"res": json.loads(result_map["res"])})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), _Req)


def serve_forever(handler, host: str = "127.0.0.1", port: int = 8080):
    srv = make_server(handler, host, port)
    print(f"serving on http://{host}:{srv.server_address[1]}/predict", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
