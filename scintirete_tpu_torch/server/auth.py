"""Password-set authentication (reference: internal/server/interfaces.go:62-83).

A copy of `scintirete_tpu/server/auth.py` on the port's own modules.

An empty password never authenticates; a server configured with no passwords
rejects every request (matches reference semantics).
"""

from __future__ import annotations

from typing import Iterable

from scintirete_tpu_torch.errors import ErrorCode, ScintireteError


class BasicAuthenticator:
    def __init__(self, passwords: Iterable[str]):
        self._valid = {p for p in passwords if p}

    def authenticate(self, password: str) -> None:
        if not password or password not in self._valid:
            raise ScintireteError(ErrorCode.UNAUTHORIZED, "invalid credentials")
