"""Per-client request rate limiting.

A copy of `scintirete_tpu/server/ratelimit.py` on the port's own modules.

The reference DEFINES a RateLimiter capability for request-abuse control
(reference: internal/core/interfaces.go:265-278 — Allow/GetLimit/SetLimit)
but never wires an implementation into the request path; here it is both
implemented (token bucket per key) and enforced in Service._begin.

Disabled by default ([server] rate_limit_rps = 0) to match the reference's
effective behavior.
"""

from __future__ import annotations

import threading
import time

from scintirete_tpu_torch.errors import ErrorCode, ScintireteError


class TokenBucketLimiter:
    """Token bucket per key: sustained `rps` with `burst` headroom.

    Keys are caller identities (the service passes hashed user ids).
    Per-key overrides via set_limit (reference SetLimit parity).
    """

    def __init__(self, rps: float, burst: int | None = None):
        self.rps = float(rps)
        self.burst = float(burst if burst is not None else max(rps * 2, 1))
        self._lock = threading.Lock()
        # key -> [tokens, last_refill_ts, rps, burst]
        self._buckets: dict[str, list[float]] = {}
        self._overrides: dict[str, tuple[float, float]] = {}

    @property
    def enabled(self) -> bool:
        return self.rps > 0

    def allow(self, key: str) -> None:
        """Admit or raise RATE_LIMITED (reference Allow semantics)."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            rps, burst = self._overrides.get(key, (self.rps, self.burst))
            if rps <= 0:  # per-key unlimited override
                return
            b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = [burst, now]
            tokens, last = b
            tokens = min(burst, tokens + (now - last) * rps)
            if tokens < 1.0:
                b[0], b[1] = tokens, now
                raise ScintireteError(
                    ErrorCode.RATE_LIMITED,
                    f"rate limit exceeded ({rps:g} req/s)",
                )
            b[0], b[1] = tokens - 1.0, now

    def get_limit(self, key: str) -> tuple[float, float]:
        """(requests_per_second, burst) in effect for key."""
        with self._lock:
            return self._overrides.get(key, (self.rps, self.burst))

    def set_limit(self, key: str, rps: float, burst: float) -> None:
        with self._lock:
            self._overrides[key] = (float(rps), float(burst))
            self._buckets.pop(key, None)  # re-fill at the new burst
