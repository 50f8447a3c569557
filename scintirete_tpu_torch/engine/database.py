"""Database registry and the top-level Engine. Port of
`scintirete_tpu/engine/database.py`; the engine passes its torch `device`
down to every collection. AOF replay (`apply_command`) and the AOF-rewrite
source (`get_optimized_commands`) go with the persistence layer and are not
ported yet.

Capability parity with the reference's engine
(reference: internal/core/database/database.go:18-908): named databases
holding named collections, create/drop/list/get, aggregate stats, and the
snapshot half of the persistence bridge (export/restore).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from scintirete_tpu_torch.engine.collection import Collection
from scintirete_tpu_torch.errors import (
    ErrorCode,
    ScintireteError,
    collection_exists,
    collection_not_found,
    db_exists,
    db_not_found,
)
from scintirete_tpu_torch.types import CollectionConfig, DatabaseInfo


class Database:
    """Named container of collections (reference: database.go:173-269)."""

    def __init__(self, name: str, use_device: bool = True, tpu_config=None,
                 device="cuda"):
        self.name = name
        self.device = device
        self._tpu = tpu_config
        self._collections: dict[str, Collection] = {}
        self._lock = threading.RLock()
        self.created_at = time.time()
        self.last_access = self.created_at
        self._use_device = use_device

    def _touch(self) -> None:
        self.last_access = time.time()

    def create_collection(self, config: CollectionConfig) -> Collection:
        with self._lock:
            self._touch()
            if config.name in self._collections:
                raise collection_exists(config.name)
            col = Collection(
                config, use_device=self._use_device, tpu_config=self._tpu,
                device=self.device,
            )
            self._collections[config.name] = col
            return col

    def drop_collection(self, name: str) -> None:
        with self._lock:
            self._touch()
            if name not in self._collections:
                raise collection_not_found(name)
            del self._collections[name]

    def get_collection(self, name: str) -> Collection:
        with self._lock:
            self._touch()
            col = self._collections.get(name)
            if col is None:
                raise collection_not_found(name)
            return col

    def list_collections(self) -> list[str]:
        with self._lock:
            self._touch()
            return sorted(self._collections)

    def collections(self) -> list[Collection]:
        with self._lock:
            return list(self._collections.values())

    def info(self) -> DatabaseInfo:
        with self._lock:
            return DatabaseInfo(
                name=self.name,
                collection_count=len(self._collections),
                created_at=self.created_at,
                last_access=self.last_access,
            )


class Engine:
    """Top-level registry of databases + the persistence bridge."""

    def __init__(self, use_device: bool = True, tpu_config=None,
                 device="cuda"):
        self.device = device
        self._databases: dict[str, Database] = {}
        self._lock = threading.RLock()
        self._use_device = use_device
        self._tpu = tpu_config

    # ----- database management -----

    def create_database(self, name: str) -> Database:
        if not name:
            raise ScintireteError(
                ErrorCode.INVALID_PARAMETER, "database name must not be empty"
            )
        with self._lock:
            if name in self._databases:
                raise db_exists(name)
            db = Database(
                name, use_device=self._use_device, tpu_config=self._tpu,
                device=self.device,
            )
            self._databases[name] = db
            return db

    def drop_database(self, name: str) -> None:
        with self._lock:
            if name not in self._databases:
                raise db_not_found(name)
            del self._databases[name]

    def get_database(self, name: str) -> Database:
        with self._lock:
            db = self._databases.get(name)
            if db is None:
                raise db_not_found(name)
            return db

    def has_database(self, name: str) -> bool:
        with self._lock:
            return name in self._databases

    def list_databases(self) -> list[str]:
        with self._lock:
            return sorted(self._databases)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            total_vectors = 0
            total_memory = 0
            total_collections = 0
            for db in self._databases.values():
                for col in db.collections():
                    info = col.info()
                    total_vectors += info.vector_count
                    total_memory += info.memory_bytes
                    total_collections += 1
            return {
                "databases": len(self._databases),
                "collections": total_collections,
                "vectors": total_vectors,
                "memory_bytes": total_memory,
            }

    def close(self) -> None:
        with self._lock:
            self._databases.clear()

    # ----- persistence bridge: snapshot -----

    def export_state(self) -> dict[str, Any]:
        """Full engine snapshot including exact HNSW graphs
        (reference: database.go:324-395 GetDatabaseState)."""
        with self._lock:
            return {
                "version": "1.0",
                "timestamp": time.time(),
                "databases": {
                    name: {
                        "created_at": db.created_at,
                        "collections": {
                            col.name: col.export_state() for col in db.collections()
                        },
                    }
                    for name, db in self._databases.items()
                },
            }

    def restore_state(self, state: dict[str, Any]) -> None:
        """Replace all in-memory state from a snapshot. Requires graph state
        for non-empty collections (reference: database.go:461-463 hard error
        when the HNSW graph is absent)."""
        with self._lock:
            if state.get("version") != "1.0":
                raise ScintireteError(
                    ErrorCode.CORRUPTED_DATA,
                    f"unsupported snapshot version: {state.get('version')!r}",
                )
            databases: dict[str, Database] = {}
            for name, db_state in state.get("databases", {}).items():
                db = Database(
                    name, use_device=self._use_device, tpu_config=self._tpu,
                    device=self.device,
                )
                db.created_at = db_state.get("created_at", time.time())
                for col_name, col_state in db_state.get("collections", {}).items():
                    col = Collection.from_state(
                        col_state,
                        use_device=self._use_device,
                        tpu_config=self._tpu,
                        device=self.device,
                    )
                    db._collections[col_name] = col
                databases[name] = db
            self._databases = databases

    # ----- persistence bridge: AOF (not ported yet) -----

    def apply_command(self, cmd: dict[str, Any]) -> None:
        raise NotImplementedError(
            "AOF replay is not ported yet: ROADMAP.md Queue 1, persistence item"
        )

    def get_optimized_commands(self, batch_size: int = 100) -> list[dict[str, Any]]:
        raise NotImplementedError(
            "the AOF rewrite source is not ported yet: ROADMAP.md Queue 1, "
            "persistence item"
        )
