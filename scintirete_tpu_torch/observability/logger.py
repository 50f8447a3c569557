"""Structured leveled logger. A copy of
`scintirete_tpu/observability/logger.py`.

Capability parity with the reference logger
(reference: internal/observability/logger/logger.go:56-100): levels
debug/info/warn/error, text or JSON line output, `with_fields` child loggers.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, IO, Optional

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


class StructuredLogger:
    def __init__(
        self,
        level: str = "info",
        fmt: str = "json",
        stream: Optional[IO[str]] = None,
        fields: Optional[dict[str, Any]] = None,
    ):
        if level not in _LEVELS:
            raise ValueError(f"invalid log level: {level}")
        if fmt not in ("text", "json"):
            raise ValueError(f"invalid log format: {fmt}")
        self.level = level
        self.fmt = fmt
        self.stream = stream if stream is not None else sys.stderr
        self.fields = dict(fields or {})
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, cfg) -> "StructuredLogger":
        return cls(level=cfg.level, fmt=cfg.format)

    def with_fields(self, **fields: Any) -> "StructuredLogger":
        merged = dict(self.fields)
        merged.update(fields)
        child = StructuredLogger(self.level, self.fmt, self.stream, merged)
        child._lock = self._lock
        return child

    def _log(self, level: str, msg: str, fields: dict[str, Any]) -> None:
        if _LEVELS[level] < _LEVELS[self.level]:
            return
        record = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "level": level,
            "msg": msg,
        }
        record.update(self.fields)
        record.update(fields)
        if self.fmt == "json":
            line = json.dumps(record, default=str)
        else:
            extras = " ".join(
                f"{k}={v}" for k, v in record.items() if k not in ("ts", "level", "msg")
            )
            line = f"{record['ts']} [{level.upper()}] {msg}" + (
                f" {extras}" if extras else ""
            )
        with self._lock:
            self.stream.write(line + "\n")
            self.stream.flush()

    def debug(self, msg: str, **fields: Any) -> None:
        self._log("debug", msg, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._log("info", msg, fields)

    def warn(self, msg: str, **fields: Any) -> None:
        self._log("warn", msg, fields)

    def error(self, msg: str, **fields: Any) -> None:
        self._log("error", msg, fields)
