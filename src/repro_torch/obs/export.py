"""Metric exporters: Prometheus/OpenMetrics text, HTTP endpoint, JSONL.

Three ways out of the process for the :mod:`repro_torch.obs.registry` state:

* :func:`prometheus_text` — OpenMetrics-flavoured text exposition
  (cumulative ``le`` buckets, ``_total`` counters, ``# EOF``), with
  per-bucket exemplars carrying the tracer span id that produced the
  latest observation, so a slow latency bucket links straight to its
  Chrome-trace span.
* :class:`MetricsServer` — a stdlib ``ThreadingHTTPServer`` serving
  ``/metrics`` (text format), ``/metrics.json`` (snapshot), and
  ``/healthz``.
* :class:`JsonlSink` — append-a-snapshot-per-line file sink for offline
  trend analysis.

:func:`parse_prometheus_text` is the strict line-grammar counterpart the
tests run over the endpoint's output, so the
exposition never drifts from something a real scraper would accept.
"""
from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

from repro_torch.obs.registry import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

# Prometheus metric-name alphabet; everything else becomes "_".
_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "repro_"


def _metric_name(name: str) -> str:
    return _PREFIX + _NAME_SANITIZE.sub("_", name)


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return format(float(v), ".10g")


def prometheus_text(registry: MetricsRegistry | None = None) -> str:
    """Render a registry in Prometheus text exposition format.

    Counters get the ``_total`` suffix, histograms cumulative ``le``
    buckets (``+Inf`` last) plus ``_sum``/``_count``, and buckets whose
    latest observation ran inside a tracer span carry an OpenMetrics
    exemplar: ``... # {span_id="17"} 42.5``.
    """
    reg = registry if registry is not None else REGISTRY
    lines: list[str] = []
    for name, metric in sorted(reg.metrics().items()):
        pname = _metric_name(name)
        if isinstance(metric, Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname}_total {_fmt(metric.value)}")
        elif isinstance(metric, Gauge):
            v = metric.value
            if not isinstance(v, (int, float)):
                continue  # non-numeric gauge (never set); unexportable
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(v)}")
        elif isinstance(metric, Histogram):
            lines.append(f"# TYPE {pname} histogram")
            counts = metric.summary()["buckets"]
            exemplars = metric.exemplars()
            cum = 0
            for i, b in enumerate(metric.buckets):
                cum += counts[f"le_{b:g}"]
                line = f'{pname}_bucket{{le="{_fmt(b)}"}} {cum}'
                ex = exemplars[i]
                if ex is not None:
                    line += f' # {{span_id="{ex[1]}"}} {_fmt(ex[0])}'
                lines.append(line)
            cum += counts["overflow"]
            line = f'{pname}_bucket{{le="+Inf"}} {cum}'
            ex = exemplars[-1]
            if ex is not None:
                line += f' # {{span_id="{ex[1]}"}} {_fmt(ex[0])}'
            lines.append(line)
            lines.append(f"{pname}_sum {_fmt(metric.sum)}")
            lines.append(f"{pname}_count {metric.count}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# --- strict parser ---------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>[+-]?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf)|NaN)"
    r"(?: # \{(?P<exlabels>[^}]*)\} "
    r"(?P<exvalue>[+-]?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf)|NaN))?$")
_LABEL_RE = re.compile(r'^([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"$')
_COMMENT_RE = re.compile(r"^# (?:TYPE|HELP|UNIT) [a-zA-Z_:][a-zA-Z0-9_:]* .+$")


def _parse_labels(raw: str | None) -> dict[str, str]:
    labels: dict[str, str] = {}
    if not raw:
        return labels
    for pair in raw.split(","):
        m = _LABEL_RE.match(pair.strip())
        if m is None:
            raise ValueError(f"malformed label pair: {pair!r}")
        labels[m.group(1)] = m.group(2)
    return labels


def parse_prometheus_text(text: str) -> dict[str, list[dict[str, Any]]]:
    """Parse text exposition back into samples; raise on any bad line.

    Returns ``{metric_name: [{"labels": {...}, "value": float,
    "exemplar": {"labels": {...}, "value": float} | None}, ...]}``.
    Deliberately strict — this is the grammar gate the tests lean on,
    not a lenient convenience parser.
    """
    out: dict[str, list[dict[str, Any]]] = {}
    saw_eof = False
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if saw_eof:
            raise ValueError(f"line {lineno}: content after # EOF")
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("#"):
            if _COMMENT_RE.match(line) is None:
                raise ValueError(f"line {lineno}: malformed comment: {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        exemplar = None
        if m.group("exvalue") is not None:
            exemplar = {"labels": _parse_labels(m.group("exlabels")),
                        "value": float(m.group("exvalue"))}
        out.setdefault(m.group("name"), []).append(
            {"labels": _parse_labels(m.group("labels")),
             "value": float(m.group("value")),
             "exemplar": exemplar})
    if not saw_eof:
        raise ValueError("missing # EOF terminator")
    return out


# --- HTTP endpoint ---------------------------------------------------------

class MetricsServer:
    """Stdlib HTTP exporter for a metrics registry.

    ``port=0`` binds an ephemeral port (read it back from ``.port``);
    the server runs on one daemon thread and every route renders at
    request time, so scrapes always see live values:

    * ``GET /metrics`` — Prometheus text format (:func:`prometheus_text`)
    * ``GET /metrics.json`` — ``registry.snapshot()`` as JSON
    * ``GET /healthz`` — ``{"ok": true, ...}``, merged with the optional
      ``health_fn()`` dict (the serving tier plugs its HealthMonitor in)
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 port: int = 0, host: str = "127.0.0.1",
                 health_fn: Callable[[], dict] | None = None):
        reg = registry if registry is not None else REGISTRY
        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path == "/metrics":
                    body = prometheus_text(reg).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/metrics.json":
                    body = json.dumps(reg.snapshot(), default=str).encode()
                    ctype = "application/json"
                elif self.path == "/healthz":
                    payload = {"ok": True}
                    if health_fn is not None:
                        payload.update(health_fn())
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log events
                del args

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-exporter", daemon=True)
        self._started = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def close(self) -> None:
        if self._started:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
        self._httpd.server_close()

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


# --- JSONL sink ------------------------------------------------------------

class JsonlSink:
    """Append one timestamped registry snapshot per line to a file."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8")

    def emit(self, registry: MetricsRegistry | None = None,
             **extra: Any) -> dict[str, Any]:
        reg = registry if registry is not None else REGISTRY
        record = {"ts": time.time(), **extra, "metrics": reg.snapshot()}
        line = json.dumps(record, default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
        return record

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
