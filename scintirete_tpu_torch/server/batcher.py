"""Dynamic request batching for the search path.

A copy of `scintirete_tpu/server/batcher.py` on the port's own modules.

The reference serves each query on its own goroutine under a RWMutex — fine
for a CPU, wrong for a GPU, where throughput comes from batched dispatch.
This batcher coalesces concurrent single-query Search RPCs into one device
program launch: requests queue up and flush when either `max_batch` requests
are waiting or the oldest has waited `max_delay_ms` (the standard serving
trade between latency and device utilization).

Requests are grouped by (collection identity, search params) since those
determine the compiled kernel; a group per distinct key flushes
independently. Falls through to direct execution when batching is disabled.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

import numpy as np


class _Pending:
    __slots__ = ("query", "event", "result", "error")

    def __init__(self, query: np.ndarray):
        self.query = query
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None


class SearchBatcher:
    def __init__(
        self,
        max_batch: int = 256,
        max_delay_ms: float = 2.0,
        enabled: bool = True,
    ):
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1000.0
        self.enabled = enabled
        # (width, wall_seconds) of recent waves — serving diagnostics
        # (chip_smoke.py reads them); deque append is O(1)/lock-free
        from collections import deque

        self.wave_log: Any = deque(maxlen=4096)
        self._lock = threading.Lock()
        # key -> (executor, [pending], first_enqueue_time)
        self._groups: dict[Any, list] = {}
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="search-batcher", daemon=True
        )
        if enabled:
            self._thread.start()

    def submit(
        self,
        key: Any,
        query: np.ndarray,
        execute_batch: Callable[[np.ndarray], list],
    ):
        """Enqueue one query; blocks until its result is ready.

        `execute_batch(queries [B, D]) -> list of per-query results` runs the
        fused device dispatch for a whole flushed group.
        """
        if not self.enabled:
            return execute_batch(query[None, :])[0]
        # the query's dimension is part of the group identity: one
        # wrong-dimension request must fail ALONE with its own
        # dimension_mismatch, not poison np.stack / the whole fused
        # dispatch for every other client coalesced under the same key
        key = (key, int(query.shape[-1]))
        pending = _Pending(query)
        flush_now = None
        with self._lock:
            group = self._groups.get(key)
            if group is None:
                group = [execute_batch, [], time.time()]
                self._groups[key] = group
            group[1].append(pending)
            if len(group[1]) >= self.max_batch:
                flush_now = self._take_locked(key)
            else:
                self._wake.notify()
        if flush_now is not None:
            self._run(flush_now)
        if not pending.event.wait(timeout=60.0):
            raise TimeoutError("batched search timed out")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _take_locked(self, key):
        group = self._groups.pop(key, None)
        if group is None or not group[1]:
            return None
        return group

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
                now = time.time()
                due = [
                    key
                    for key, group in self._groups.items()
                    if now - group[2] >= self.max_delay
                ]
                batches = [self._take_locked(key) for key in due]
                if not batches:
                    # wake when the oldest group comes due
                    timeout = self.max_delay
                    if self._groups:
                        oldest = min(g[2] for g in self._groups.values())
                        timeout = max(oldest + self.max_delay - now, 0.0005)
                    self._wake.wait(timeout=timeout)
                    continue
            for group in batches:
                if group is not None:
                    self._run(group)

    def _run(self, group) -> None:
        execute_batch, pendings, _ = group
        t0 = time.perf_counter()
        try:
            queries = np.stack([p.query for p in pendings])
            results = execute_batch(queries)
            for p, r in zip(pendings, results):
                p.result = r
        except BaseException as exc:  # propagate to every waiter
            for p in pendings:
                p.error = exc
        finally:
            self.wave_log.append(
                (len(pendings), time.perf_counter() - t0)
            )
            for p in pendings:
                p.event.set()

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._wake.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
