"""Live scrape + health endpoints.

A copy of ``repro/obs/scrape.py`` (pure Python).  ``ScrapeServer`` is a
stdlib ``http.server`` on its own daemon thread, three read-only
endpoints over state the process already holds:

  ``GET /metrics``
      The shared ``MetricsRegistry`` as Prometheus text exposition
      (v0.0.4) -- what a fleet scraper or ``curl | promtool`` ingests;
      strict-round-trippable through ``obs.metrics.parse_prometheus``.
  ``GET /healthz``
      ``200 ok`` while the process serves (an optional ``health_fn``
      can veto with 503) -- the load-balancer liveness probe.
  ``GET /statusz``
      The ``status_fn()`` dict as JSON: engine stats, admission queue
      depths, skew summary -- the human-facing "what is it doing"
      page, also consumed by ``python -m repro_torch.obs.report --url``.

Everything is read-only and allocation-light, so scraping during live
load is safe by construction -- with one caveat: the registry and the
engine's session table mutate on other threads while a handler walks
them, and a dict that changes size mid-iteration raises
``RuntimeError``.  Scrapes are eventually consistent by design, so the
handler just retries the walk a few times (``_RETRIES``); a scrape that
loses the race three times in a row returns 503 and the scraper's next
interval catches up.

Standalone use is two lines::

    srv = ScrapeServer(obs.registry)
    host, port = srv.start()          # port=0 picks a free port
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

# retries for registry/engine walks racing a mutating thread
_RETRIES = 3

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _stable_read(fn: Callable[[], Any], retries: int = _RETRIES) -> Any:
    """Run a read over concurrently mutated dicts, retrying the
    ``RuntimeError: dictionary changed size during iteration`` race."""
    for attempt in range(retries):
        try:
            return fn()
        except RuntimeError:
            if attempt == retries - 1:
                raise
    raise AssertionError("unreachable")  # pragma: no cover


class ScrapeServer:
    """The HTTP sidecar: one ``ThreadingHTTPServer`` on a daemon thread.

    Args:
      registry: the ``MetricsRegistry`` behind ``/metrics``.
      status_fn: zero-arg callable returning the JSON-able ``/statusz``
        body (``None`` -> ``/statusz`` serves ``{}``).
      health_fn: zero-arg callable; falsy return -> ``/healthz`` 503
        (``None`` -> always healthy while the thread runs).
      host/port: bind address; ``port=0`` picks a free port
        (``start()`` returns the resolved address).
    """

    def __init__(self, registry, *,
                 status_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 health_fn: Optional[Callable[[], bool]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.status_fn = status_fn
        self.health_fn = health_fn
        self.host, self.port = host, int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._addr: Optional[Tuple[str, int]] = None

    # ------------------------------------------------------------ lifecycle

    @property
    def address(self) -> Tuple[str, int]:
        if self._addr is None:
            raise RuntimeError("scrape server not started; call start()")
        return self._addr

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> Tuple[str, int]:
        if self._httpd is not None:
            return self.address
        scrape = self

        class _Handler(BaseHTTPRequestHandler):
            # one scrape per connection keeps the thread pool bounded
            protocol_version = "HTTP/1.0"

            def log_message(self, *a):       # quiet: no stderr per scrape
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        text = _stable_read(scrape.registry.prometheus_text)
                        self._send(200, PROM_CONTENT_TYPE,
                                   text.encode("utf-8"))
                    elif path == "/healthz":
                        ok = (scrape.health_fn is None
                              or bool(_stable_read(scrape.health_fn)))
                        self._send(200 if ok else 503,
                                   "text/plain; charset=utf-8",
                                   b"ok\n" if ok else b"unhealthy\n")
                    elif path == "/statusz":
                        body = ({} if scrape.status_fn is None
                                else _stable_read(scrape.status_fn))
                        self._send(200, "application/json",
                                   json.dumps(body, indent=2,
                                              default=str).encode("utf-8"))
                    else:
                        self._send(404, "text/plain; charset=utf-8",
                                   b"not found; endpoints: /metrics "
                                   b"/healthz /statusz\n")
                except RuntimeError:
                    # lost the mutation race _RETRIES times; next scrape
                    # interval will catch up
                    self._send(503, "text/plain; charset=utf-8",
                               b"busy; retry\n")
                except (BrokenPipeError, ConnectionError):
                    pass                    # scraper hung up mid-reply

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self._addr = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-scrape",
            kwargs={"poll_interval": 0.1}, daemon=True)
        self._thread.start()
        return self._addr

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "ScrapeServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
