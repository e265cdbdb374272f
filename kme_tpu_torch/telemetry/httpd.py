"""Tiny stdlib HTTP surface for a Registry.

The port's copy of `kme_tpu/telemetry/httpd.py`.

`kme-torch-serve --metrics-port N` starts this; GET /metrics returns
Prometheus text exposition (0.0.4), GET /metrics.json the JSON
snapshot. The handler only reads registry snapshots (taken under the
registry lock) — it never touches device tensors, so it is safe beside
the serve thread that owns the card.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def start_metrics_server(registry, port: int, host: str = "0.0.0.0"):
    """Serve `registry` on (host, port) from a daemon thread.

    Returns the ThreadingHTTPServer (port=0 picks a free port —
    read it back from server.server_address; call shutdown() to stop).
    """

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            path = self.path.split("?", 1)[0]
            try:
                if path in ("/metrics", "/"):
                    body = registry.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = registry.to_json().encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
            except Exception as e:   # a broken metric must not 200-empty
                self.send_error(500, explain=str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # scrapes are not news
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    thread = threading.Thread(
        target=server.serve_forever, name="kme-metrics-http", daemon=True)
    thread.start()
    return server
