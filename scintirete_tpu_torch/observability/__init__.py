"""Observability: structured logging, audit log, Prometheus metrics,
monitor. Port of `scintirete_tpu/observability/`."""

from scintirete_tpu_torch.observability.logger import StructuredLogger  # noqa: F401
from scintirete_tpu_torch.observability.audit import AuditLogger  # noqa: F401
from scintirete_tpu_torch.observability.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    MetricsServer,
)
