"""JSON-lines audit log.

A copy of `scintirete_tpu/observability/audit.py` on the port's own modules.

Capability parity with the reference audit logger
(reference: internal/observability/audit/audit.go:25-116): OPERATION/ACCESS/
SECURITY events with timestamp, operation, database, collection, a hashed
user id (sha256 prefix of the password, reference: grpc/helpers.go:75-82),
and free-form metadata; file output with size-based rotation.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Optional


def hash_user_id(password: str) -> str:
    """Privacy-preserving user identifier (reference: grpc/helpers.go:75-82)."""
    if not password:
        return "anonymous"
    return hashlib.sha256(password.encode()).hexdigest()[:16]


class AuditLogger:
    LEVELS = ("OPERATION", "ACCESS", "SECURITY")

    def __init__(
        self,
        path: Optional[str] = None,
        enabled: bool = True,
        max_size_bytes: int = 64 * 1024 * 1024,
        max_files: int = 5,
    ):
        self.enabled = enabled
        self.path = path
        self.max_size_bytes = max_size_bytes
        self.max_files = max_files
        self._lock = threading.Lock()
        self._fh = None
        if enabled and path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(
        self,
        level: str,
        operation: str,
        database: str = "",
        collection: str = "",
        user_id: str = "",
        metadata: Optional[dict[str, Any]] = None,
    ) -> None:
        if not self.enabled or self._fh is None:
            return
        if level not in self.LEVELS:
            level = "OPERATION"
        event = {
            "timestamp": time.time(),
            "level": level,
            "operation": operation,
            "database": database,
            "collection": collection,
            "user_id": user_id,
            "metadata": metadata or {},
        }
        line = json.dumps(event, default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            if self._fh.tell() >= self.max_size_bytes:
                self._rotate_locked()

    def log_operation(self, operation: str, **kw: Any) -> None:
        self.log("OPERATION", operation, **kw)

    def log_access(self, operation: str, **kw: Any) -> None:
        self.log("ACCESS", operation, **kw)

    def log_security(self, operation: str, **kw: Any) -> None:
        self.log("SECURITY", operation, **kw)

    def _rotate_locked(self) -> None:
        # shift path -> .1 -> .2 -> ... -> .{max_files-1}, dropping the oldest
        self._fh.close()
        for i in range(self.max_files - 2, 0, -1):
            older = f"{self.path}.{i}"
            if os.path.exists(older):
                os.replace(older, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "a")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
                self.enabled = False
