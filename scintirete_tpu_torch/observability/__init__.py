"""Observability: structured logging. Port of
`scintirete_tpu/observability/`; the audit log, the metrics and the
monitor come with the server."""

from scintirete_tpu_torch.observability.logger import StructuredLogger  # noqa: F401
