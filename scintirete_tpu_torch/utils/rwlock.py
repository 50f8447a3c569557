"""Reader-writer lock for index/collection concurrency.

A copy of `scintirete_tpu/utils/rwlock.py`: the port imports nothing of
the JAX package.

The reference serves concurrent readers through sync.RWMutex
(reference: internal/core/algorithm/hnsw.go:292 — Search takes RLock so
readers share). Python's stdlib has no RW lock, so this is a small
condition-variable implementation with two deliberate policy choices:

- **Readers pass whenever no writer is ACTIVE** (no writer-preference).
  Writers here are either short mutations or a bulk builder that
  re-acquires the write side once per chunk; with writer-preference the
  waiting builder would starve every reader for the whole build — exactly
  the round-1 behavior this lock exists to remove. The builder instead
  waits for in-flight readers to drain at each chunk boundary, which
  bounds reader latency by one chunk and writer delay by one search batch.
- **Read sections may nest** (a read-locked method may call another
  read-locked method on the same thread). This is deadlock-free precisely
  because readers never wait on *waiting* writers, only on active ones —
  a thread inside a read section can never observe an active writer.

Write sections are NOT reentrant and must not be entered while holding the
read side; callers (HNSWIndex, Collection) serialize their writers through
a separate mutex and keep write sections short and non-nested.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

from scintirete_tpu_torch.observability import trace


class RWLock:
    __slots__ = ("_cond", "_readers", "_writer")

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    @contextmanager
    def read(self, span: Optional[str] = None):
        """The read side; `span` names a tracer span around its
        acquisition (the wait for an active writer included)."""
        with trace.span(span) if span else trace.NO_SPAN, self._cond:
            while self._writer:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            while self._writer or self._readers:
                self._cond.wait()
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()
