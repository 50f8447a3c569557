"""Database registry and the top-level Engine. Port of
`scintirete_tpu/engine/database.py`; the engine passes its torch `device`
down to every collection.

Capability parity with the reference's engine
(reference: internal/core/database/database.go:18-908): named databases
holding named collections, create/drop/list/get, aggregate stats, and the
persistence bridge — snapshot export/restore, AOF command replay
(`apply_command`, 6 command types) and AOF-rewrite source
(`get_optimized_commands`, inserts re-batched in groups of 100).
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

# AOF command types (reference: schemas/flatbuffers/aof.fbs:37-45)
CMD_CREATE_DATABASE = "CREATE_DATABASE"
CMD_DROP_DATABASE = "DROP_DATABASE"
CMD_CREATE_COLLECTION = "CREATE_COLLECTION"
CMD_DROP_COLLECTION = "DROP_COLLECTION"
CMD_INSERT_VECTORS = "INSERT_VECTORS"
CMD_DELETE_VECTORS = "DELETE_VECTORS"

ALL_COMMANDS = (
    CMD_CREATE_DATABASE,
    CMD_DROP_DATABASE,
    CMD_CREATE_COLLECTION,
    CMD_DROP_COLLECTION,
    CMD_INSERT_VECTORS,
    CMD_DELETE_VECTORS,
)


def make_command(
    command_type: str,
    database: str,
    collection: str = "",
    args: Optional[dict[str, Any]] = None,
    timestamp: Optional[float] = None,
) -> dict[str, Any]:
    """A logical AOF command record (serialization lives in persistence/aof)."""
    return {
        "timestamp": timestamp if timestamp is not None else time.time(),
        "command_type": command_type,
        "database": database,
        "collection": collection,
        "args": args or {},
    }


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

    # ----- persistence bridge: AOF replay -----

    def apply_command(self, cmd: dict[str, Any]) -> None:
        """Apply one logical AOF command
        (reference: database.go:496-613 ApplyCommand)."""
        ctype = cmd["command_type"]
        dbname = cmd.get("database", "")
        colname = cmd.get("collection", "")
        args = cmd.get("args", {})

        if ctype == CMD_CREATE_DATABASE:
            if not self.has_database(dbname):
                self.create_database(dbname)
        elif ctype == CMD_DROP_DATABASE:
            if self.has_database(dbname):
                self.drop_database(dbname)
        elif ctype == CMD_CREATE_COLLECTION:
            db = self.get_database(dbname)
            if colname not in db.list_collections():
                from scintirete_tpu_torch.types import DistanceMetric, HNSWParams

                cfg = args.get("config", {})
                config = CollectionConfig(
                    name=colname,
                    metric=DistanceMetric(cfg.get("metric", 2)),
                    hnsw=HNSWParams(**cfg.get("hnsw", {})),
                    device_dtype=cfg.get("device_dtype", "float32"),
                    index_type=cfg.get("index_type", "hnsw"),
                )
                col = db.create_collection(config)
                # rewrite streams only re-INSERT live ids; without the
                # high-water mark a restart would re-issue the ids of
                # deleted vectors (the RDB path persists next_id — the
                # rewrite stream needs the same)
                if "next_id" in args:
                    col._next_id = max(col._next_id, int(args["next_id"]))
        elif ctype == CMD_DROP_COLLECTION:
            db = self.get_database(dbname)
            if colname in db.list_collections():
                db.drop_collection(colname)
        elif ctype == CMD_INSERT_VECTORS:
            col = self.get_database(dbname).get_collection(colname)
            # at-least-once replay: an insert can be both in the snapshot and
            # in the AOF tail (mutation before snapshot capture, append after
            # truncation) — skip ids that already exist instead of failing
            vectors = [
                (int(v["id"]), v["elements"], v.get("metadata"))
                for v in args.get("vectors", [])
                if not col.has_id(int(v["id"]))
            ]
            col.insert_with_ids(vectors)
        elif ctype == CMD_DELETE_VECTORS:
            col = self.get_database(dbname).get_collection(colname)
            col.delete([int(i) for i in args.get("ids", [])])
        else:
            raise ScintireteError(
                ErrorCode.CORRUPTED_DATA, f"unknown AOF command type: {ctype!r}"
            )

    # ----- persistence bridge: AOF rewrite source -----

    def get_optimized_commands(self, batch_size: int = 100) -> list[dict[str, Any]]:
        """Minimal command stream recreating current state
        (reference: database.go:616-710 — CREATE_DATABASE/CREATE_COLLECTION/
        INSERT_VECTORS in batches)."""
        import dataclasses as dc

        commands: list[dict[str, Any]] = []
        with self._lock:
            for dbname in self.list_databases():
                db = self._databases[dbname]
                commands.append(make_command(CMD_CREATE_DATABASE, dbname))
                for col in db.collections():
                    commands.append(
                        make_command(
                            CMD_CREATE_COLLECTION,
                            dbname,
                            col.name,
                            {
                                "config": {
                                    "metric": int(col.config.metric),
                                    "hnsw": dc.asdict(col.config.hnsw),
                                    "device_dtype": col.config.device_dtype,
                                    "index_type": col.config.index_type,
                                },
                                # preserve the auto-ID high-water mark: the
                                # live-vector stream alone would let a
                                # restart reuse deleted vectors' ids
                                "next_id": col._next_id,
                            },
                        )
                    )
                    live: list[dict[str, Any]] = []
                    index = col._index
                    if index is None:
                        continue
                    # iterate a STABLE copy: concurrent inserts mutate
                    # id_to_slot under the index's own lock, which this
                    # background reader does not hold
                    rw = getattr(index, "_rw", None)
                    if rw is not None:
                        with rw.read():
                            id_list = sorted(index.id_to_slot)
                    else:
                        while True:
                            try:
                                id_list = sorted(index.id_to_slot)
                                break
                            except RuntimeError:
                                continue  # dict resized mid-iteration
                    for vid in id_list:
                        if not index.contains(vid):
                            continue
                        vec = col.get(vid)
                        live.append(
                            {
                                "id": vid,
                                "elements": vec.elements,
                                "metadata": vec.metadata,
                            }
                        )
                        if len(live) == batch_size:
                            commands.append(
                                make_command(
                                    CMD_INSERT_VECTORS,
                                    dbname,
                                    col.name,
                                    {"vectors": live},
                                )
                            )
                            live = []
                    if live:
                        commands.append(
                            make_command(
                                CMD_INSERT_VECTORS, dbname, col.name, {"vectors": live}
                            )
                        )
        return commands
