"""Live metrics exposition for ``python -m ppls_tpu_torch serve``: a
tiny stdlib HTTP server rendering the registry as Prometheus text
(format 0.0.4) on ``GET /metrics`` (any path works — curl-from-memory
friendly). The port's copy of the JAX package's ``obs/server.py``
(host-only Python, unchanged).

``GET /health`` returns the SLO burn-rate verdict as JSON
(``{"ok": bool, "burning": [...], "phase": p}``; HTTP 200 when ok,
503 while any SLO is burning) when the caller supplies a ``health_fn``
— the load-balancer yes/no face of the engine's SLO verdict
(``StreamEngine.slo_health``). Without a health_fn the path serves
metrics like every other.

Runs in a daemon thread so the serve loop never blocks on a scraper;
``port=0`` binds an ephemeral port (tests read ``server.port``). The
registry snapshot is rendered per request — scrape cost is linear in
metric count, zero cost when nobody scrapes.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    def __init__(self, registry, port: int = 0,
                 host: str = "127.0.0.1", health_fn=None):
        """``registry``: a :class:`MetricsRegistry`, or a zero-arg
        callable returning one (the serve CLI re-points the handle
        when a watchdog retry rebuilds its engine). ``health_fn``: a
        zero-arg callable returning the /health verdict dict (an
        ``"ok"`` bool plus whatever detail the evaluator carries)."""
        get_reg = registry if callable(registry) else (lambda: registry)

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):           # noqa: N802 — stdlib API name
                if health_fn is not None \
                        and self.path.split("?")[0] == "/health":
                    verdict = health_fn()
                    body = (json.dumps(verdict) + "\n").encode("utf-8")
                    self.send_response(
                        200 if verdict.get("ok", True) else 503)
                    self.send_header("Content-Type",
                                     "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                reg = get_reg()
                body = reg.exposition().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # keep stdout/stderr clean
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ppls-metrics",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
