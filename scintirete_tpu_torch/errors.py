"""Typed errors with the reference's numeric error-code contract.

A copy of `scintirete_tpu/errors.py`: the port imports nothing of the JAX
package.

Reference: internal/utils/errors.go:12-51 — codes are grouped by thousands:
1000s system, 2000s auth, 3000s business, 4000s persistence, 5000s algorithm,
6000s external embedding service. Clients that matched on these codes against
the reference keep working against this engine.
"""

from __future__ import annotations

import enum
from typing import Any, Optional


class ErrorCode(enum.IntEnum):
    # System errors (1000-1999)
    INTERNAL = 1000
    CONFIG = 1001
    TIMEOUT = 1002
    RESOURCE = 1003

    # Authentication errors (2000-2999)
    UNAUTHORIZED = 2000
    FORBIDDEN = 2001
    RATE_LIMITED = 2002

    # Business errors (3000-3999)
    DATABASE_NOT_FOUND = 3000
    DATABASE_ALREADY_EXISTS = 3001
    COLLECTION_NOT_FOUND = 3002
    COLLECTION_ALREADY_EXISTS = 3003
    VECTOR_NOT_FOUND = 3004
    DIMENSION_MISMATCH = 3005
    INVALID_VECTOR_ID = 3006
    INVALID_PARAMETER = 3007
    EMPTY_COLLECTION = 3008

    # Persistence errors (4000-4999)
    PERSISTENCE_FAILED = 4000
    RECOVERY_FAILED = 4001
    CORRUPTED_DATA = 4002
    DISK_SPACE = 4003

    # Algorithm errors (5000-5999)
    INDEX_BUILD_FAILED = 5000
    SEARCH_FAILED = 5001
    INSERT_FAILED = 5002
    DELETE_FAILED = 5003

    # External service errors (6000-6999)
    EMBEDDING_API_FAILED = 6000
    EMBEDDING_TIMEOUT = 6001
    EMBEDDING_QUOTA_EXCEEDED = 6002


class ScintireteError(Exception):
    """Engine error carrying a numeric code, message, and optional details."""

    def __init__(
        self,
        code: ErrorCode,
        message: str,
        details: Optional[dict[str, Any]] = None,
        cause: Optional[BaseException] = None,
    ):
        super().__init__(f"[{int(code)}:{code.name}] {message}")
        self.code = code
        self.message = message
        self.details = details or {}
        if cause is not None:
            self.__cause__ = cause

    @property
    def category(self) -> str:
        return {
            1: "system",
            2: "auth",
            3: "business",
            4: "persistence",
            5: "algorithm",
            6: "external",
        }[int(self.code) // 1000]

    def to_dict(self) -> dict[str, Any]:
        return {
            "code": int(self.code),
            "name": self.code.name,
            "message": self.message,
            "details": self.details,
        }


def db_not_found(name: str) -> ScintireteError:
    return ScintireteError(ErrorCode.DATABASE_NOT_FOUND, f"database not found: {name}")


def db_exists(name: str) -> ScintireteError:
    return ScintireteError(
        ErrorCode.DATABASE_ALREADY_EXISTS, f"database already exists: {name}"
    )


def collection_not_found(name: str) -> ScintireteError:
    return ScintireteError(
        ErrorCode.COLLECTION_NOT_FOUND, f"collection not found: {name}"
    )


def collection_exists(name: str) -> ScintireteError:
    return ScintireteError(
        ErrorCode.COLLECTION_ALREADY_EXISTS, f"collection already exists: {name}"
    )


def dimension_mismatch(expected: int, got: int) -> ScintireteError:
    return ScintireteError(
        ErrorCode.DIMENSION_MISMATCH,
        f"vector dimension mismatch: expected {expected}, got {got}",
        details={"expected": expected, "got": got},
    )
