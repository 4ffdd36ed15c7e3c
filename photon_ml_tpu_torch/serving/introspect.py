"""Live serving introspection: /metrics, /healthz, /varz over HTTP.

A running ``serve_game`` is opaque without this — the metrics snapshot
only surfaces when the replay finishes. :class:`IntrospectionServer` is a
stdlib-only (``http.server``) daemon-thread HTTP server exposing:

* ``/metrics`` — the process MetricsRegistry in Prometheus text exposition
  format (version 0.0.4), see :func:`prometheus_text` for the naming
  scheme;
* ``/healthz`` — JSON liveness + hot-swap/validation-gate state (HTTP 503
  when the supplied health callback reports unhealthy);
* ``/varz`` — JSON dump of the active (possibly auto-tuned) config;
* ``/quitquitquit`` — releases an ``--introspect-hold`` wait, so tests and
  operators can end a held server deterministically.

Bind is loopback by default; this is an operator port, not a public one.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

__all__ = ["prometheus_text", "IntrospectionServer"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_PREFIX = "photon_"


def _prom_name(name: str, prefix: str = _PROM_PREFIX) -> str:
    """Registry metric name → Prometheus metric name.

    Scheme (documented in docs/OBSERVABILITY.md): prepend ``photon_``,
    replace every character outside ``[a-zA-Z0-9_:]`` with ``_`` (so
    ``serving.latency_p99_ms`` → ``photon_serving_latency_p99_ms``), and
    prefix a leading digit with ``_``."""
    body = _NAME_RE.sub("_", name)
    if body and body[0].isdigit():
        body = "_" + body
    return prefix + body


def _prom_value(value: Any) -> str:
    v = float(value)
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if not float(v).is_integer() else str(int(v))


def _split_name(name: str) -> tuple:
    """Registry name → (family, label block). ``MetricsRegistry.scoped``
    stores labeled metrics as ``base{k="v",...}``; everything else is an
    unlabeled family."""
    if name.endswith("}") and "{" in name:
        base, labels = name.split("{", 1)
        return base, "{" + labels
    return name, ""


def _sample(pname: str, labels: str, extra: str = "") -> str:
    """One sample name: the Prometheus family name plus the stored label
    block, with an optional extra label (``quantile="0.5"``) merged in."""
    inner = labels[1:-1] if labels else ""
    if extra:
        inner = f"{inner},{extra}" if inner else extra
    return f"{pname}{{{inner}}}" if inner else pname


def prometheus_text(snapshot: Dict[str, Any], prefix: str = _PROM_PREFIX) -> str:
    """Render a MetricsRegistry snapshot as Prometheus text exposition
    (format version 0.0.4).

    * counters → ``counter`` samples;
    * gauges → two ``gauge`` samples, the last value and ``<name>_peak``;
    * histograms → a ``summary``: ``<name>{quantile="0.5|0.95|0.99"}``,
      ``<name>_count``, and a ``<name>_max`` gauge (the registry keeps
      digests, not sums, so no ``_sum`` sample is emitted).

    Names carrying a label block (written through
    ``MetricsRegistry.scoped``, e.g. ``serving.requests{tenant="a"}``)
    render as labeled samples of one family: the ``# TYPE`` header is
    emitted once per family and only the family name is sanitized, so
    per-tenant series group under one metric the way Prometheus expects.
    """
    lines = []

    def families(section):
        fams: Dict[str, list] = {}
        for name, value in sorted((snapshot.get(section) or {}).items()):
            base, labels = _split_name(name)
            fams.setdefault(base, []).append((labels, value))
        return sorted(fams.items())

    for base, samples in families("counters"):
        pname = _prom_name(base, prefix)
        lines.append(f"# TYPE {pname} counter")
        for labels, value in samples:
            lines.append(f"{_sample(pname, labels)} {_prom_value(value)}")
    for base, samples in families("gauges"):
        pname = _prom_name(base, prefix)
        lines.append(f"# TYPE {pname} gauge")
        for labels, g in samples:
            lines.append(f"{_sample(pname, labels)} {_prom_value(g['last'])}")
        lines.append(f"# TYPE {pname}_peak gauge")
        for labels, g in samples:
            lines.append(
                f"{_sample(pname + '_peak', labels)} {_prom_value(g['peak'])}"
            )
    for base, samples in families("histograms"):
        pname = _prom_name(base, prefix)
        lines.append(f"# TYPE {pname} summary")
        max_lines = []
        for labels, h in samples:
            for q in ("p50", "p95", "p99"):
                if q in h:
                    quantile = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}[q]
                    qlabel = 'quantile="%s"' % quantile
                    lines.append(
                        f"{_sample(pname, labels, qlabel)}"
                        f" {_prom_value(h[q])}"
                    )
            lines.append(
                f"{_sample(pname + '_count', labels)} "
                f"{_prom_value(h.get('count', 0))}"
            )
            if "max" in h:
                max_lines.append(
                    f"{_sample(pname + '_max', labels)} {_prom_value(h['max'])}"
                )
        if max_lines:
            lines.append(f"# TYPE {pname}_max gauge")
            lines.extend(max_lines)
    return "\n".join(lines) + "\n"


class IntrospectionServer:
    """Daemon-thread HTTP server for the three serving endpoints.

    ``registry`` backs /metrics; ``varz`` and ``health`` are zero-arg
    callables returning JSON-able dicts, re-evaluated per request so the
    endpoints always reflect live state (hot-swap generation, tuned
    config). ``health`` may include ``"healthy": False`` to flip /healthz
    to HTTP 503."""

    def __init__(
        self,
        registry=None,
        varz: Optional[Callable[[], Dict[str, Any]]] = None,
        health: Optional[Callable[[], Dict[str, Any]]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        extra_json: Optional[Dict[str, Callable[[], Any]]] = None,
    ):
        if registry is None:
            from photon_ml_tpu_torch.telemetry.metrics import get_registry

            registry = get_registry()
        self.registry = registry
        self._varz = varz or (lambda: {})
        self._health = health or (lambda: {})
        # extra JSON endpoints (path -> zero-arg callable returning a
        # JSON-able value), re-evaluated per request like varz/health; the
        # training plane mounts /progress here
        self._extra = {
            "/" + p.strip("/"): fn for p, fn in (extra_json or {}).items()
        }
        self._quit = threading.Event()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, body: str, content_type: str) -> None:
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        self._reply(
                            200,
                            prometheus_text(outer.registry.snapshot()),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/healthz":
                        doc = {"healthy": True}
                        doc.update(outer._health() or {})
                        code = 200 if doc.get("healthy", True) else 503
                        self._reply(
                            code,
                            json.dumps(doc, indent=2, sort_keys=True, default=str),
                            "application/json",
                        )
                    elif path == "/varz":
                        self._reply(
                            200,
                            json.dumps(
                                outer._varz() or {},
                                indent=2,
                                sort_keys=True,
                                default=str,
                            ),
                            "application/json",
                        )
                    elif path == "/quitquitquit":
                        outer._quit.set()
                        self._reply(200, "bye\n", "text/plain")
                    elif path in outer._extra:
                        self._reply(
                            200,
                            json.dumps(
                                outer._extra[path](),
                                indent=2,
                                sort_keys=True,
                                default=str,
                            ),
                            "application/json",
                        )
                    else:
                        self._reply(404, "not found\n", "text/plain")
                except Exception as e:  # endpoint bugs must not kill serving
                    try:
                        self._reply(500, f"error: {e}\n", "text/plain")
                    except Exception:
                        pass

            do_POST = do_GET

            def log_message(self, fmt, *args):  # quiet: operator port
                pass

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="photon-introspect",
            daemon=True,
        )

    @property
    def port(self) -> int:
        return int(self._server.server_address[1])

    @property
    def host(self) -> str:
        return str(self._server.server_address[0])

    def start(self) -> "IntrospectionServer":
        self._thread.start()
        return self

    def wait_quit(self, timeout: Optional[float] = None) -> bool:
        """Block until /quitquitquit is hit (or timeout); used by
        ``serve_game --introspect-hold``."""
        return self._quit.wait(timeout)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
