"""Prometheus metrics: hand-rolled primitives + text exposition server.

A copy of `scintirete_tpu/observability/metrics.py` on the port's own modules.

Capability parity with the reference collector
(reference: internal/observability/metrics/metrics.go:14-130 — Counter/
Gauge/Histogram with the standard `scintirete_*` families and 12 latency
buckets from 1 ms to 10 s; exposition server with /metrics and /health on a
separate port, metrics/server.go:19-84). Unlike the reference — whose
collector exists but is never wired into main() — this registry is actually
plumbed through the request path (SURVEY.md §2.6 note).
"""

from __future__ import annotations

import http.server
import threading
import time
from typing import Optional

LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0, 10.0,
)


def _esc_label(v: str) -> str:
    """Prometheus text-format label escaping: backslash, double quote and
    newline must be escaped or one hostile collection name (e.g. 'a\"b')
    corrupts the whole /metrics page for every scraper."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_esc_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def get(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            if not self._values:
                lines.append(f"{self.name} 0")
            for key, value in sorted(self._values.items()):
                lines.append(f"{self.name}{_fmt_labels(dict(key))} {value}")
        return lines


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def add(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def get(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            if not self._values:
                lines.append(f"{self.name} 0")
            for key, value in sorted(self._values.items()):
                lines.append(f"{self.name}{_fmt_labels(dict(key))} {value}")
        return lines


class Histogram:
    def __init__(self, name: str, help_: str = "", buckets=LATENCY_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for key in sorted(self._counts):
                base = dict(key)
                for i, ub in enumerate(self.buckets):
                    lines.append(
                        f"{self.name}_bucket{_fmt_labels({**base, 'le': repr(ub)})} "
                        f"{self._counts[key][i]}"
                    )
                lines.append(
                    f"{self.name}_bucket{_fmt_labels({**base, 'le': '+Inf'})} "
                    f"{self._totals[key]}"
                )
                lines.append(
                    f"{self.name}_sum{_fmt_labels(base)} {self._sums[key]}"
                )
                lines.append(
                    f"{self.name}_count{_fmt_labels(base)} {self._totals[key]}"
                )
        return lines


class MetricsRegistry:
    """The standard scintirete metric families (reference: metrics.go:96-130)."""

    def __init__(self):
        self.start_time = time.time()
        self.requests_total = Counter(
            "scintirete_requests_total", "Total RPC requests"
        )
        self.request_errors_total = Counter(
            "scintirete_request_errors_total", "Total failed RPC requests"
        )
        self.request_duration_seconds = Histogram(
            "scintirete_request_duration_seconds", "RPC latency"
        )
        self.vector_operations_total = Counter(
            "scintirete_vector_operations_total", "Vector ops (insert/delete/search)"
        )
        self.vector_count = Gauge(
            "scintirete_vector_count", "Live vectors per collection"
        )
        self.memory_usage_bytes = Gauge(
            "scintirete_memory_usage", "Estimated index memory per collection"
        )
        self.uptime_seconds = Gauge("scintirete_uptime_seconds", "Server uptime")
        self._all = [
            self.requests_total,
            self.request_errors_total,
            self.request_duration_seconds,
            self.vector_operations_total,
            self.vector_count,
            self.memory_usage_bytes,
            self.uptime_seconds,
        ]

    def observe_request(self, method: str, seconds: float, error: bool) -> None:
        self.requests_total.inc(method=method)
        self.request_duration_seconds.observe(seconds, method=method)
        if error:
            self.request_errors_total.inc(method=method)

    def expose_text(self) -> str:
        self.uptime_seconds.set(time.time() - self.start_time)
        lines: list[str] = []
        for metric in self._all:
            lines.extend(metric.expose())
        return "\n".join(lines) + "\n"


class MetricsServer:
    """Text exposition on a dedicated port: GET /metrics and /health
    (reference: metrics/server.go:19-84)."""

    def __init__(
        self, registry: MetricsRegistry, host: str = "127.0.0.1", port: int = 9100,
        path: str = "/metrics",
    ):
        self.registry = registry
        self.path = path
        registry_ref = registry
        metrics_path = path

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path == metrics_path:
                    body = registry_ref.expose_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                elif self.path == "/health":
                    body = b'{"status":"ok"}'
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                else:
                    body = b"not found"
                    self.send_response(404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence default stderr spam
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-server", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2.0)
