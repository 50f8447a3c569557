"""OpenAI-`/v1/embeddings`-compatible HTTP client.

A copy of `scintirete_tpu/embedding/client.py` on the port's own modules.

Capability parity with the reference client
(reference: internal/embedding/client.go:66-265): bearer-auth POST of
`{"input": [texts], "model": ...}`, parses `{"data": [{index, embedding}],
"usage": {...}}`, model catalog + default model from config. Improvement
over the reference: the sliding-window RPM/TPM rate limiter is actually
enforced (the reference implements it but comments the enforcement out,
client.go:129-144).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Optional, Sequence

from scintirete_tpu_torch.config import EmbeddingConfig, EmbeddingModel
from scintirete_tpu_torch.errors import ErrorCode, ScintireteError


class RateCounter:
    """Sliding one-minute window over (requests, tokens)."""

    def __init__(self, rpm_limit: int, tpm_limit: int):
        self.rpm_limit = rpm_limit
        self.tpm_limit = tpm_limit
        self._events: list[tuple[float, int]] = []  # (timestamp, tokens)
        self._lock = threading.Lock()

    def _prune_locked(self, now: float) -> None:
        cutoff = now - 60.0
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)

    def check_and_record(self, tokens: int) -> None:
        now = time.time()
        with self._lock:
            self._prune_locked(now)
            requests = len(self._events)
            total_tokens = sum(t for _, t in self._events)
            if self.rpm_limit > 0 and requests + 1 > self.rpm_limit:
                raise ScintireteError(
                    ErrorCode.EMBEDDING_QUOTA_EXCEEDED,
                    f"embedding RPM limit exceeded ({self.rpm_limit}/min)",
                )
            if self.tpm_limit > 0 and total_tokens + tokens > self.tpm_limit:
                raise ScintireteError(
                    ErrorCode.EMBEDDING_QUOTA_EXCEEDED,
                    f"embedding TPM limit exceeded ({self.tpm_limit}/min)",
                )
            self._events.append((now, tokens))


def _estimate_tokens(texts: Sequence[str]) -> int:
    # coarse 4-chars-per-token heuristic, same purpose as the reference's
    return sum(max(1, len(t) // 4) for t in texts)


class EmbeddingClient:
    def __init__(self, config: EmbeddingConfig, timeout_seconds: float = 30.0):
        self.config = config
        self.timeout = timeout_seconds
        self.rate = RateCounter(config.rpm_limit, config.tpm_limit)

    # ----- model catalog -----

    def get_models(self) -> list[EmbeddingModel]:
        return list(self.config.models)

    def get_default_model(self) -> str:
        return self.config.default_model

    def resolve_model(self, model: Optional[str]) -> str:
        return model if model else self.config.default_model

    # ----- embedding calls -----

    def get_embeddings(
        self, texts: Sequence[str], model: Optional[str] = None
    ) -> list[list[float]]:
        """Embed a batch of texts; order matches the input."""
        if not texts:
            return []
        model = self.resolve_model(model)
        self.rate.check_and_record(_estimate_tokens(texts))
        payload = json.dumps({"input": list(texts), "model": model}).encode()
        req = urllib.request.Request(
            self.config.base_url,
            data=payload,
            method="POST",
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.config.api_key}",
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")[:500]
            raise ScintireteError(
                ErrorCode.EMBEDDING_API_FAILED,
                f"embedding API returned {exc.code}: {detail}",
                cause=exc,
            )
        except (urllib.error.URLError, TimeoutError, OSError) as exc:
            raise ScintireteError(
                ErrorCode.EMBEDDING_TIMEOUT,
                f"embedding API unreachable: {exc}",
                cause=exc,
            )
        # everything below parses UNTRUSTED response bytes: any shape
        # surprise (HTML body behind a proxy, data: 123, missing keys)
        # must surface as EMBEDDING_API_FAILED, not a raw
        # JSONDecodeError/TypeError/KeyError through the gRPC layer
        try:
            body = json.loads(raw.decode(errors="replace"))
            data = body.get("data") if isinstance(body, dict) else None
            if not isinstance(data, list) or len(data) != len(texts):
                got = len(data) if isinstance(data, list) else repr(data)[:80]
                raise ScintireteError(
                    ErrorCode.EMBEDDING_API_FAILED,
                    "embedding API returned malformed data",
                    details={"expected": len(texts), "got": got},
                )
            # order by returned index (reference: client.go data[].index)
            out: list[Optional[list[float]]] = [None] * len(texts)
            for item in data:
                idx = int(item["index"])
                if not (0 <= idx < len(texts)):
                    raise ScintireteError(
                        ErrorCode.EMBEDDING_API_FAILED,
                        f"embedding API returned out-of-range index {idx}",
                    )
                out[idx] = [float(x) for x in item["embedding"]]
            if any(v is None for v in out):
                raise ScintireteError(
                    ErrorCode.EMBEDDING_API_FAILED,
                    "embedding API missing indices",
                )
            return out  # type: ignore[return-value]
        except ScintireteError:
            raise
        except Exception as exc:
            raise ScintireteError(
                ErrorCode.EMBEDDING_API_FAILED,
                f"embedding API response unparseable: {exc}",
                cause=exc,
            )

    def get_single_embedding(
        self, text: str, model: Optional[str] = None
    ) -> list[float]:
        return self.get_embeddings([text], model)[0]

    def texts_to_vectors(
        self,
        texts: Sequence[str],
        metadatas: Optional[Sequence[Optional[dict[str, Any]]]] = None,
        model: Optional[str] = None,
    ) -> list[tuple[list[float], Optional[dict[str, Any]]]]:
        """Zip texts+metadata with their embeddings, ready for
        Collection.insert (reference: client.go:207-247)."""
        if metadatas is None:
            metadatas = [None] * len(texts)
        if len(metadatas) != len(texts):
            # zip would silently truncate to the shorter sequence,
            # dropping embeddings without any error
            raise ScintireteError(
                ErrorCode.INVALID_PARAMETER,
                f"{len(texts)} texts but {len(metadatas)} metadata entries",
            )
        embeddings = self.get_embeddings(texts, model)
        return list(zip(embeddings, metadatas))
