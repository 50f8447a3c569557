"""Point-in-time full snapshots (RDB). A copy of
`scintirete_tpu/persistence/rdb.py` on the port's `serde`.

Capability parity with the reference RDB manager
(reference: internal/persistence/rdb/rdb.go): snapshots carry ALL databases
including the complete HNSW graph state (nodes, per-layer connections,
entrypoint, maxLayer) so restore is O(load), not O(rebuild); files are
written to a temp path and atomically renamed (rdb.go:134-176); loads are
structurally validated (version, counts, rdb.go:744-789); `BackupManager`
keeps timestamped copies (rdb.go:890-979).

The on-disk payload is the engine's export_state() pytree serialized with the
msgpack+ndarray codec (serde.py) behind a magic header — the flat device
arrays (vector matrix, neighbor tables) go to disk as raw contiguous bytes.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Any, Optional

from scintirete_tpu_torch.errors import ErrorCode, ScintireteError
from scintirete_tpu_torch.persistence import serde

MAGIC = b"STRDB1\n"


class RDBManager:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def save(self, state: dict[str, Any]) -> None:
        """Atomic snapshot write (temp file + rename)."""
        payload = serde.dumps(state)
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "wb") as fh:
                fh.write(MAGIC)
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except OSError as exc:
            raise ScintireteError(
                ErrorCode.PERSISTENCE_FAILED, f"RDB save failed: {exc}", cause=exc
            )

    def load(self) -> Optional[dict[str, Any]]:
        """Returns the snapshot state, or None when no file exists
        (reference: rdb.go:179-236 — missing file is not an error)."""
        try:
            with open(self.path, "rb") as fh:
                magic = fh.read(len(MAGIC))
                if magic != MAGIC:
                    raise ScintireteError(
                        ErrorCode.CORRUPTED_DATA, "RDB bad magic header"
                    )
                payload = fh.read()
        except FileNotFoundError:
            return None
        try:
            state = serde.loads(payload)
        except ScintireteError:
            raise
        except Exception as exc:
            raise ScintireteError(
                ErrorCode.CORRUPTED_DATA, f"RDB undecodable: {exc}", cause=exc
            )
        self.validate(state)
        return state

    @staticmethod
    def validate(state: dict[str, Any]) -> None:
        """Structural validation (reference: rdb.go:744-789). Any
        malformed shape must surface as CORRUPTED_DATA (the degraded
        recovery path catches ScintireteError and sets the snapshot
        aside; a bare KeyError/TypeError would abort startup instead)."""
        try:
            RDBManager._validate(state)
        except ScintireteError:
            raise
        except Exception as exc:
            raise ScintireteError(
                ErrorCode.CORRUPTED_DATA,
                f"RDB structurally damaged: {exc!r}",
                cause=exc,
            )

    @staticmethod
    def _validate(state: dict[str, Any]) -> None:
        if state.get("version") != "1.0":
            raise ScintireteError(
                ErrorCode.CORRUPTED_DATA,
                f"RDB unsupported version: {state.get('version')!r}",
            )
        dbs = state.get("databases")
        if not isinstance(dbs, dict):
            raise ScintireteError(ErrorCode.CORRUPTED_DATA, "RDB missing databases")
        for dbname, db in dbs.items():
            if not dbname:
                raise ScintireteError(
                    ErrorCode.CORRUPTED_DATA, "RDB empty database name"
                )
            for colname, col in db.get("collections", {}).items():
                graph = col.get("graph")
                if graph is None or graph.get("sharded"):
                    continue  # per-shard states are validated on import
                n = int(graph["count"])
                if graph.get("kind") == "flat":
                    keys = ("vectors", "deleted", "slot_to_id")
                else:
                    keys = ("vectors", "levels", "deleted", "neighbors0")
                for key in keys:
                    if len(graph[key]) != n:
                        raise ScintireteError(
                            ErrorCode.CORRUPTED_DATA,
                            f"RDB {dbname}/{colname}: inconsistent {key} length",
                        )
                if graph["live"] > n:
                    raise ScintireteError(
                        ErrorCode.CORRUPTED_DATA,
                        f"RDB {dbname}/{colname}: live > count",
                    )

    def set_aside_corrupt(self) -> Optional[str]:
        """Move a corrupt snapshot out of the way (degraded recovery keeps
        the bytes for manual repair instead of deleting or crashing —
        reference policy: persistence.go:185-305). Returns the new path."""
        if not self.exists():
            return None
        dest = f"{self.path}.corrupt-{int(time.time())}"
        i = 0
        while os.path.exists(dest):
            i += 1
            dest = f"{self.path}.corrupt-{int(time.time())}.{i}"
        os.replace(self.path, dest)
        return dest

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except FileNotFoundError:
            return 0


class BackupManager:
    """Timestamped snapshot copies (reference: rdb.go:890-979)."""

    def __init__(self, rdb: RDBManager, backup_dir: Optional[str] = None):
        self.rdb = rdb
        self.backup_dir = backup_dir or os.path.join(
            os.path.dirname(os.path.abspath(rdb.path)), "backups"
        )

    def create_backup(self) -> str:
        if not self.rdb.exists():
            raise ScintireteError(
                ErrorCode.PERSISTENCE_FAILED, "no RDB snapshot to back up"
            )
        os.makedirs(self.backup_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        base = os.path.basename(self.rdb.path)
        dest = os.path.join(self.backup_dir, f"{base}.{stamp}")
        i = 0
        while os.path.exists(dest):
            i += 1
            dest = os.path.join(self.backup_dir, f"{base}.{stamp}.{i}")
        shutil.copy2(self.rdb.path, dest)
        return dest

    def list_backups(self) -> list[str]:
        if not os.path.isdir(self.backup_dir):
            return []
        base = os.path.basename(self.rdb.path)
        return sorted(
            os.path.join(self.backup_dir, f)
            for f in os.listdir(self.backup_dir)
            if f.startswith(base + ".")
        )

    def restore_backup(self, backup_path: str) -> None:
        if not os.path.exists(backup_path):
            raise ScintireteError(
                ErrorCode.PERSISTENCE_FAILED, f"backup not found: {backup_path}"
            )
        shutil.copy2(backup_path, self.rdb.path)
