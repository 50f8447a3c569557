"""Persistence orchestration: AOF + RDB + recovery + background maintenance.
Port of `scintirete_tpu/persistence/manager.py` onto the port's engine.

Capability parity with the reference manager
(reference: internal/persistence/persistence.go):

- every successful write op appends one AOF command AFTER the engine mutation
  succeeds (call sites mirror grpc/vector_ops.go:74-84),
- recovery = load RDB (if any) -> restore engine -> replay AOF tail
  (persistence.go:166-330),
- a successful RDB snapshot truncates the AOF (persistence.go:333-362), so
  the AOF always holds "changes since last snapshot",
- background "smart" RDB snapshots: only when dirty AND (>=200 commands OR
  >=30 min since last snapshot), checked every rdb_interval
  (persistence.go:517-547),
- background "smart" AOF rewrite: checked every 5 min; rewrite when the file
  exceeds the size threshold AND grew >=50% since the last rewrite
  (persistence.go:557-620).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

from scintirete_tpu_torch.engine.database import (
    CMD_CREATE_COLLECTION,
    CMD_CREATE_DATABASE,
    CMD_DELETE_VECTORS,
    CMD_DROP_COLLECTION,
    CMD_DROP_DATABASE,
    CMD_INSERT_VECTORS,
    Engine,
    make_command,
)
from scintirete_tpu_torch.persistence.aof import AOFLogger, SyncStrategy
from scintirete_tpu_torch.persistence.rdb import RDBManager

SNAPSHOT_MIN_COMMANDS = 200
SNAPSHOT_MAX_AGE_SECONDS = 30 * 60
AOF_REWRITE_CHECK_SECONDS = 5 * 60
AOF_REWRITE_GROWTH = 1.5


class PersistenceManager:
    def __init__(
        self,
        engine: Engine,
        data_dir: str,
        rdb_filename: str = "vector.rdb",
        aof_filename: str = "appendonly.aof",
        aof_sync_strategy: str = "everysec",
        rdb_interval_seconds: float = 300.0,
        aof_rewrite_size_bytes: int = 5 * 1024 * 1024,
        snapshot_min_commands: int = SNAPSHOT_MIN_COMMANDS,
        snapshot_max_age_seconds: float = SNAPSHOT_MAX_AGE_SECONDS,
        aof_rewrite_check_seconds: float = AOF_REWRITE_CHECK_SECONDS,
        strict_recovery: bool = False,
        logger=None,
    ):
        os.makedirs(data_dir, exist_ok=True)
        self.engine = engine
        self.data_dir = data_dir
        self.rdb = RDBManager(os.path.join(data_dir, rdb_filename))
        self.aof = AOFLogger(
            os.path.join(data_dir, aof_filename), SyncStrategy(aof_sync_strategy)
        )
        self.rdb_interval_seconds = rdb_interval_seconds
        self.aof_rewrite_size_bytes = aof_rewrite_size_bytes
        self.snapshot_min_commands = snapshot_min_commands
        self.snapshot_max_age_seconds = snapshot_max_age_seconds
        self.aof_rewrite_check_seconds = aof_rewrite_check_seconds
        # strict: corruption anywhere aborts recovery with CORRUPTED_DATA.
        # default (reference policy, persistence.go:185-305): warn, preserve
        # the corrupt file on disk, and recover everything salvageable.
        self.strict_recovery = strict_recovery
        self.logger = logger

        self._lock = threading.Lock()
        # serializes AOF appends against rewrite's capture-and-swap: a write
        # landing between engine-state capture and the file swap would be
        # silently dropped from the rewritten log (data loss the reference
        # shares — fixed here)
        self._aof_write_gate = threading.Lock()
        self._dirty_commands = 0
        self._last_snapshot = time.time()
        self._last_rewrite_size = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._stats = {
            "aof_writes": 0,
            "snapshots": 0,
            "rewrites": 0,
            "recovered_commands": 0,
            "recovered_from_rdb": False,
        }

    # ----- write path -----

    def write_aof(self, cmd: dict[str, Any]) -> None:
        with self._aof_write_gate:
            self.aof.write_command(cmd)
        with self._lock:
            self._dirty_commands += 1
            self._stats["aof_writes"] += 1

    # command builders (reference: persistence.go:470-503)

    def log_create_database(self, db: str) -> None:
        self.write_aof(make_command(CMD_CREATE_DATABASE, db))

    def log_drop_database(self, db: str) -> None:
        self.write_aof(make_command(CMD_DROP_DATABASE, db))

    def log_create_collection(self, db: str, col: str, config: dict[str, Any]) -> None:
        self.write_aof(make_command(CMD_CREATE_COLLECTION, db, col, {"config": config}))

    def log_drop_collection(self, db: str, col: str) -> None:
        self.write_aof(make_command(CMD_DROP_COLLECTION, db, col))

    def log_insert_vectors(self, db: str, col: str, vectors: list[dict]) -> None:
        self.write_aof(make_command(CMD_INSERT_VECTORS, db, col, {"vectors": vectors}))

    def log_delete_vectors(self, db: str, col: str, ids: list[int]) -> None:
        self.write_aof(make_command(CMD_DELETE_VECTORS, db, col, {"ids": ids}))

    # ----- recovery -----

    def recover(self) -> dict[str, Any]:
        """RDB load -> engine restore -> AOF tail replay
        (reference: persistence.go:166-330).

        Unless ``strict_recovery``, corruption degrades instead of failing
        (reference warns and preserves, persistence.go:185-305): a corrupt
        RDB is set aside as ``<path>.corrupt-<ts>`` and recovery proceeds
        from the AOF alone; a corrupt AOF tail is salvaged to the last good
        record (the crash-mid-append signature), with the original kept.
        """
        from scintirete_tpu_torch.errors import ErrorCode, ScintireteError

        t0 = time.time()
        degraded: list[dict[str, Any]] = []
        try:
            state = self.rdb.load()
        except ScintireteError as exc:
            if self.strict_recovery or exc.code != ErrorCode.CORRUPTED_DATA:
                raise
            preserved = self.rdb.set_aside_corrupt()
            degraded.append({"source": "rdb", "reason": str(exc),
                             "preserved_as": preserved})
            if self.logger:
                self.logger.warn(
                    "corrupt RDB set aside; recovering from AOF only",
                    error=str(exc), preserved_as=preserved,
                )
            state = None
        if state is not None:
            self.engine.restore_state(state)
            self._stats["recovered_from_rdb"] = True

        def on_salvage(detail: dict[str, Any]) -> None:
            degraded.append({"source": "aof", **detail})
            if self.logger:
                self.logger.warn("corrupt AOF tail salvaged", **detail)

        def apply(cmd: dict[str, Any]) -> None:
            # tolerant apply: engine mutations and their AOF appends are
            # not atomic (reference has the same pattern: mutate, then
            # log — grpc/vector_ops.go:74-84), so a concurrent
            # drop/insert race can log commands out of engine order. A
            # replay failure on one record must degrade with a warning,
            # not abort startup with an unreplayable log.
            try:
                self.engine.apply_command(cmd)
            except ScintireteError as exc:
                if self.strict_recovery:
                    raise
                detail = {
                    "source": "aof_apply",
                    "reason": str(exc),
                    "command_type": cmd.get("command_type"),
                    "database": cmd.get("database"),
                    "collection": cmd.get("collection"),
                }
                degraded.append(detail)
                if self.logger:
                    self.logger.warn(
                        "AOF command skipped during replay", **detail
                    )

        replayed = self.aof.replay(
            apply,
            salvage=not self.strict_recovery,
            on_salvage=on_salvage,
        )
        self._stats["recovered_commands"] = replayed
        elapsed = time.time() - t0
        if self.logger:
            self.logger.info(
                "recovery complete",
                rdb=state is not None,
                aof_commands=replayed,
                seconds=round(elapsed, 3),
            )
        return {
            "rdb_loaded": state is not None,
            "aof_commands": replayed,
            "seconds": elapsed,
            "degraded": degraded,
        }

    # ----- snapshots -----

    def save_snapshot(self) -> None:
        """Synchronous snapshot; truncates the AOF on success
        (reference: persistence.go:333-362). Appends are gated from state
        capture through truncation: an append racing in between would
        otherwise be truncated away without being in the snapshot."""
        with self._aof_write_gate:
            state = self.engine.export_state()
            self.rdb.save(state)
            self.aof.truncate()
        with self._lock:
            self._dirty_commands = 0
            self._last_snapshot = time.time()
            self._last_rewrite_size = 0
            self._stats["snapshots"] += 1

    def background_save(self) -> threading.Thread:
        """Async snapshot (reference: BgSave grpc/server.go:241-303)."""
        t = threading.Thread(target=self._bg_save_safe, name="bgsave", daemon=True)
        t.start()
        return t

    def _bg_save_safe(self) -> None:
        try:
            self.save_snapshot()
        except Exception as exc:  # pragma: no cover - logged, not raised
            if self.logger:
                self.logger.error("background save failed", error=str(exc))

    def maybe_snapshot(self) -> bool:
        """Smart gate (reference: persistence.go:517-547)."""
        with self._lock:
            dirty = self._dirty_commands
            age = time.time() - self._last_snapshot
        if dirty == 0:
            return False
        if dirty < self.snapshot_min_commands and age < self.snapshot_max_age_seconds:
            return False
        self.save_snapshot()
        return True

    def maybe_rewrite_aof(self) -> bool:
        """Smart gate (reference: persistence.go:557-620).

        The rewritten log is a FULL-state command stream (CREATE + INSERT of
        live data only). Recovery replays the AOF on top of the RDB snapshot,
        so a rewrite while an RDB exists would resurrect anything deleted
        since that snapshot (the rewrite carries no DELETE/DROP records for
        it). When an RDB exists we therefore compact via a fresh snapshot
        instead — it truncates the AOF, which is a strictly stronger rewrite
        and keeps the "AOF = changes since last snapshot" invariant. The
        plain rewrite remains for the AOF-only regime, where the
        self-contained stream IS the whole recovery source.
        """
        size = self.aof.size_bytes()
        if size <= self.aof_rewrite_size_bytes:
            return False
        with self._lock:
            last = self._last_rewrite_size
        if last > 0 and size < last * AOF_REWRITE_GROWTH:
            return False
        if self.rdb.exists():
            self.save_snapshot()
            with self._lock:
                self._stats["rewrites"] += 1
            return True
        with self._aof_write_gate:  # no appends between capture and swap
            commands = self.engine.get_optimized_commands()
            self.aof.rewrite(commands)
        with self._lock:
            self._last_rewrite_size = self.aof.size_bytes()
            self._stats["rewrites"] += 1
        return True

    # ----- background tasks -----

    def start_background_tasks(self) -> None:
        """Two maintenance loops (reference: persistence.go:365-375)."""
        self._stop.clear()
        for name, interval, fn in (
            ("rdb-snapshot", self.rdb_interval_seconds, self.maybe_snapshot),
            ("aof-rewrite", self.aof_rewrite_check_seconds, self.maybe_rewrite_aof),
        ):
            t = threading.Thread(
                target=self._task_loop, args=(interval, fn), name=name, daemon=True
            )
            t.start()
            self._threads.append(t)

    def _task_loop(self, interval: float, fn) -> None:
        while not self._stop.wait(interval):
            try:
                fn()
            except Exception as exc:  # pragma: no cover
                if self.logger:
                    self.logger.error("persistence task failed", error=str(exc))

    def stats(self) -> dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
            out["dirty_commands"] = self._dirty_commands
        out["aof"] = self.aof.stats()
        out["rdb_bytes"] = self.rdb.size_bytes()
        return out

    def stop(self) -> None:
        """Graceful stop: halt tasks, final fsync (reference: persistence.go
        Stop + aof.go:709-734)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()
        self.aof.close()
