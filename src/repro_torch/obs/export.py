"""Exporters: JSON snapshot, Prometheus text, and an HTTP endpoint.

A copy of ``repro/obs/export.py``, unchanged in behaviour.

Three views over the same ``Registry``/``TraceLog`` pair:

* ``snapshot(registry, trace)`` — point-in-time dict (what lands in
  reports and the ``/metrics.json`` endpoint).
* ``render_prometheus(registry)`` — text exposition format, one
  ``# TYPE`` header per family, histograms as cumulative
  ``_bucket{le=...}`` series plus ``_sum``/``_count``.
* ``MetricsServer`` — a daemon-thread HTTP server (``/metrics`` text,
  ``/metrics.json`` snapshot), a scrape endpoint for a serving loop.
"""
from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import Registry
from .trace import TraceLog


def snapshot(registry: Registry,
             trace: Optional[TraceLog] = None) -> dict:
    """One consistent cut: metric families plus (optionally) the span
    ring.  The two sections are each internally consistent; they are
    not atomic with respect to each other."""
    out = {"metrics": registry.snapshot()}
    if trace is not None:
        out["spans"] = trace.spans()
    return out


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    kv = dict(labels)
    if extra:
        kv.update(extra)
    if not kv:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(kv.items()))
    return "{" + body + "}"


def render_prometheus(registry: Registry) -> str:
    """Prometheus text exposition of every family in the registry."""
    lines = []
    for fam in sorted(registry.families(), key=lambda f: f.name):
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, child in sorted(fam.children()):
            labels = dict(key)
            if fam.kind == "histogram":
                cum = 0
                for b, c in zip(child.bounds, child.counts):
                    cum += c
                    le = "+Inf" if math.isinf(b) else repr(b)
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_fmt_labels(labels, {'le': le})} {cum}")
                lines.append(
                    f"{fam.name}_sum{_fmt_labels(labels)} {child.sum}")
                lines.append(
                    f"{fam.name}_count{_fmt_labels(labels)} {child.count}")
            else:
                lines.append(
                    f"{fam.name}{_fmt_labels(labels)} {child.value}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    # set per-server via a subclass attribute in MetricsServer
    registry: Registry = None  # type: ignore[assignment]
    trace: Optional[TraceLog] = None

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.startswith("/metrics.json"):
            body = json.dumps(snapshot(self.registry, self.trace),
                              default=str).encode()
            ctype = "application/json"
        elif self.path.startswith("/metrics"):
            body = render_prometheus(self.registry).encode()
            ctype = "text/plain; version=0.0.4"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):   # keep the serving loop's stdout clean
        pass


class MetricsServer:
    """HTTP scrape endpoint on a background daemon thread.

    ``port=0`` binds an ephemeral port (tests); ``.port`` reports the
    bound port.  ``close()`` shuts the listener down; callers that
    outlive the process simply abandon it (daemon thread).
    """

    def __init__(self, registry: Registry, port: int = 0,
                 trace: Optional[TraceLog] = None, host: str = "127.0.0.1"):
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": registry, "trace": trace})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self.host = host
        # thread-contract: scrape listener; daemon=True, never joined —
        # close() shuts it down explicitly, process exit abandons it.
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-http",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
