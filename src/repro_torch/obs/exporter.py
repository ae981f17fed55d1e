"""Stdlib HTTP exporter serving Prometheus text at ``/metrics``.

No third-party dependency: a daemon-threaded
:class:`http.server.ThreadingHTTPServer` renders the registry on each
scrape.  ``port=0`` binds an ephemeral port (read it back from
``server.server_address``), which is what the benches and tests use.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import REGISTRY, MetricsRegistry


def serve_metrics(registry: MetricsRegistry = REGISTRY, port: int = 0,
                  host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start a daemon /metrics server; returns the (running) server.

    Call ``server.shutdown()`` to stop it; the bound port is
    ``server.server_address[1]``.
    """

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path.split("?")[0] == "/metrics":
                body = registry.render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.split("?")[0] == "/healthz":
                self.send_response(200)
                self.send_header("Content-Length", "3")
                self.end_headers()
                self.wfile.write(b"ok\n")
            else:
                self.send_error(404)

        def log_message(self, *args):  # silence per-scrape stderr spam
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="metrics-exporter", daemon=True)
    thread.start()
    return server
