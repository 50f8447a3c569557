"""Reference on-disk format interop: FlatBuffers AOF/RDB import and export.
A copy of `scintirete_tpu/persistence/fbcompat.py` on the port's engine;
only the offline admin tool imports it (it needs the `flatbuffers` package).

The reference persists FlatBuffers (schemas/flatbuffers/aof.fbs, rdb.fbs).
Framing:

- AOF  (reference: internal/persistence/aof/aof.go:115-125): a stream of
  records, each a u32 little-endian length prefix followed by one
  ``AOFCommand`` FlatBuffer.
- RDB  (reference: internal/persistence/rdb/rdb.go:190-194): one bare
  ``RDBSnapshot`` FlatBuffer, read with os.ReadFile — no extra envelope.

``flatc`` is not in this image, so the readers/writers here are hand-rolled
over the flatbuffers runtime's low-level Table/Builder API. Vtable slot
numbers follow field declaration order in the schema (slot k lives at
voffset 4 + 2k); a union field occupies TWO slots (type byte, then value) —
the same numbering the reference's generated Go code uses
(internal/flatbuffers/aof, aof.go:339-346 Add* call order).

Import maps reference files onto the engine's logical structures:
databases, collections (config incl. HNSW params), vectors with metadata.
Graph topology is deliberately NOT imported — the bulk kNN constructor
rebuilds a fresh graph orders of magnitude faster than the reference built
the original (SURVEY §6), and the flat-array store's invariants are
guaranteed by construction rather than trusted from foreign input.

Export emits reference-readable files, including full per-node
``layer_connections`` adjacency for HNSW collections (the reference's
restore path hard-errors without a graph, database.go:461-463). Flat
collections export their vectors with ``max_layer=0`` and no connections;
the reference has no flat index, so such a file round-trips vectors and
metadata but is not searchable by the reference without a rebuild.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Iterator, Optional

import numpy as np

import flatbuffers
from flatbuffers import number_types as NT
from flatbuffers.table import Table

# ---------------------------------------------------------------------------
# low-level read helpers


def _root(buf: bytes) -> Table:
    (n,) = struct.unpack_from("<I", buf, 0)
    return Table(buf, n)


class _Tbl:
    """Typed field access by schema slot number (declaration order)."""

    def __init__(self, tab: Table):
        self._t = tab

    def _off(self, slot: int) -> int:
        return self._t.Offset(4 + 2 * slot)

    def i8(self, slot: int, default: int = 0) -> int:
        o = self._off(slot)
        return int(self._t.Get(NT.Int8Flags, self._t.Pos + o)) if o else default

    def i32(self, slot: int, default: int = 0) -> int:
        o = self._off(slot)
        return int(self._t.Get(NT.Int32Flags, self._t.Pos + o)) if o else default

    def i64(self, slot: int, default: int = 0) -> int:
        o = self._off(slot)
        return int(self._t.Get(NT.Int64Flags, self._t.Pos + o)) if o else default

    def boolean(self, slot: int, default: bool = False) -> bool:
        o = self._off(slot)
        return bool(self._t.Get(NT.BoolFlags, self._t.Pos + o)) if o else default

    def string(self, slot: int, default: str = "") -> str:
        o = self._off(slot)
        if not o:
            return default
        raw = self._t.String(o + self._t.Pos)
        return raw.decode("utf-8") if isinstance(raw, (bytes, bytearray)) else raw

    def table(self, slot: int) -> Optional["_Tbl"]:
        o = self._off(slot)
        if not o:
            return None
        return _Tbl(Table(self._t.Bytes, self._t.Indirect(o + self._t.Pos)))

    def union_table(self, slot: int) -> Optional["_Tbl"]:
        o = self._off(slot)
        if not o:
            return None
        t2 = Table(bytearray(), 0)
        self._t.Union(t2, o)
        return _Tbl(Table(self._t.Bytes, t2.Pos))

    def vec_len(self, slot: int) -> int:
        o = self._off(slot)
        return self._t.VectorLen(o) if o else 0

    def vec_table(self, slot: int, j: int) -> "_Tbl":
        o = self._off(slot)
        a = self._t.Vector(o)
        return _Tbl(Table(self._t.Bytes, self._t.Indirect(a + j * 4)))

    def vec_string(self, slot: int, j: int) -> str:
        o = self._off(slot)
        a = self._t.Vector(o)
        raw = self._t.String(a + j * 4)
        return raw.decode("utf-8") if isinstance(raw, (bytes, bytearray)) else raw

    def vec_f32(self, slot: int) -> np.ndarray:
        o = self._off(slot)
        if not o:
            return np.zeros(0, np.float32)
        return np.array(self._t.GetVectorAsNumpy(NT.Float32Flags, o), np.float32)


# ---------------------------------------------------------------------------
# schema slot maps (declaration order in aof.fbs / rdb.fbs)

# aof.AOFCommand: timestamp=0 command_type=1 args_type=2 args=3 database=4
#                 collection=5  (args is a union -> two slots)
# aof.Vector / rdb.Vector: id=0 elements=1 metadata=2
# aof.HNSWParams / rdb.HNSWParams: m=0 ef_construction=1 ef_search=2
#                 max_layers=3 seed=4
# aof.CollectionConfig / rdb.CollectionConfig: name=0 metric=1 hnsw_params=2
# aof Create/DropDatabaseArgs, Drop/CollectionArgs: name=0
# aof.CreateCollectionArgs: name=0 config=1
# aof.InsertVectorsArgs: vectors=0 ; DeleteVectorsArgs: ids=0
# rdb.RDBSnapshot: version=0 timestamp=1 databases=2 metadata=3
# rdb.DatabaseSnapshot: name=0 collections=1 created_at=2
# rdb.CollectionSnapshot: name=0 config=1 vectors=2 hnsw_graph=3
#                 vector_count=4 deleted_count=5 created_at=6 updated_at=7
# rdb.HNSWGraph: nodes=0 entrypoint_id=1 max_layer=2 size=3
# rdb.HNSWNode: id=0 elements=1 metadata=2 deleted=3 layer_connections=4
#                 max_layer=5
# rdb.LayerConnections: layer=0 connected_node_ids=1

# aof.fbs CommandType values (aof.fbs:37-45) -> engine command strings
_CMD_NAMES = {
    1: "CREATE_DATABASE",
    2: "DROP_DATABASE",
    3: "CREATE_COLLECTION",
    4: "DROP_COLLECTION",
    5: "INSERT_VECTORS",
    6: "DELETE_VECTORS",
}
_CMD_TYPES = {v: k for k, v in _CMD_NAMES.items()}
# union CommandArgs member order (aof.fbs:48-55); member k has type tag k+1
_ARGS_TAGS = {
    "CREATE_DATABASE": 1,
    "DROP_DATABASE": 2,
    "CREATE_COLLECTION": 3,
    "DROP_COLLECTION": 4,
    "INSERT_VECTORS": 5,
    "DELETE_VECTORS": 6,
}


def _parse_metadata(raw: str) -> Optional[dict]:
    """Reference metadata is a JSON-encoded string; '{}' / '' mean none."""
    if not raw:
        return None
    try:
        obj = json.loads(raw)
    except ValueError:
        return None
    return obj if isinstance(obj, dict) and obj else None


def _parse_hnsw(tbl: Optional[_Tbl]) -> dict[str, Any]:
    """HNSWParams table -> kwargs for types.HNSWParams (0 -> defaults)."""
    if tbl is None:
        return {}
    out: dict[str, Any] = {}
    for key, slot in (
        ("m", 0),
        ("ef_construction", 1),
        ("ef_search", 2),
        ("max_layers", 3),
    ):
        v = tbl.i32(slot)
        if v > 0:
            out[key] = v
    seed = tbl.i64(4)
    if seed:
        out["seed"] = seed
    return out


def _parse_config(tbl: Optional[_Tbl]) -> dict[str, Any]:
    """CollectionConfig table -> the args["config"] shape apply_command eats."""
    if tbl is None:
        return {}
    return {
        "metric": tbl.i8(1) or 2,  # UNSPECIFIED -> COSINE (engine default)
        "hnsw": _parse_hnsw(tbl.table(2)),
    }


def _parse_vector(tbl: _Tbl) -> dict[str, Any]:
    return {
        "id": int(tbl.string(0) or "0"),
        "elements": tbl.vec_f32(1),
        "metadata": _parse_metadata(tbl.string(2)),
    }


# ---------------------------------------------------------------------------
# AOF import


def parse_aof_command(buf: bytes) -> dict[str, Any]:
    """One AOFCommand FlatBuffer -> the logical command dict
    Engine.apply_command accepts (engine/database.py:239)."""
    cmd = _Tbl(_root(buf))
    ctype_val = cmd.i8(1)
    name = _CMD_NAMES.get(ctype_val)
    if name is None:
        raise ValueError(f"unknown reference AOF command type: {ctype_val}")
    args_tbl = cmd.union_table(3)
    args: dict[str, Any] = {}
    if args_tbl is not None:
        if name in ("CREATE_DATABASE", "DROP_DATABASE", "DROP_COLLECTION"):
            args["name"] = args_tbl.string(0)
        elif name == "CREATE_COLLECTION":
            args["name"] = args_tbl.string(0)
            args["config"] = _parse_config(args_tbl.table(1))
        elif name == "INSERT_VECTORS":
            args["vectors"] = [
                _parse_vector(args_tbl.vec_table(0, j))
                for j in range(args_tbl.vec_len(0))
            ]
        elif name == "DELETE_VECTORS":
            args["ids"] = [
                args_tbl.vec_string(0, j) for j in range(args_tbl.vec_len(0))
            ]
    return {
        "timestamp": float(cmd.i64(0)),
        "command_type": name,
        "database": cmd.string(4),
        "collection": cmd.string(5),
        "args": args,
    }


def iter_aof(path: str) -> Iterator[dict[str, Any]]:
    """Stream logical commands from a reference AOF file.

    Framing and validation mirror the reference's Replay
    (aof.go:169-213): u32 LE length, 100 MB sanity cap, hard error on a
    torn record (the reference treats any framing damage as corruption)."""
    with open(path, "rb") as f:
        n = 0
        while True:
            n += 1
            head = f.read(4)
            if not head:
                return
            if len(head) < 4:
                raise ValueError(f"truncated length prefix at command {n}")
            (length,) = struct.unpack("<I", head)
            if length == 0 or length > 100 * 1024 * 1024:
                raise ValueError(f"invalid command length {length} at command {n}")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"truncated command data at command {n}")
            yield parse_aof_command(data)


# ---------------------------------------------------------------------------
# RDB import


def read_rdb(path: str) -> dict[str, Any]:
    """Reference RDBSnapshot file -> a logical snapshot dict.

    Shape::

        {"version", "timestamp", "metadata",
         "databases": {name: {"created_at", "collections": {name: {
             "config": {"metric", "hnsw"},
             "vectors": [{"id", "elements", "metadata", "deleted"}],
             "entrypoint_id", "max_layer",
             "vector_count", "deleted_count", "created_at", "updated_at"}}}}}

    Node adjacency is parsed but not returned (see module docstring:
    topology is rebuilt, not trusted)."""
    with open(path, "rb") as f:
        buf = f.read()
    snap = _Tbl(_root(buf))
    out: dict[str, Any] = {
        "version": snap.string(0),
        "timestamp": snap.i64(1),
        "metadata": _parse_metadata(snap.string(3)),
        "databases": {},
    }
    for i in range(snap.vec_len(2)):
        db = snap.vec_table(2, i)
        cols: dict[str, Any] = {}
        for j in range(db.vec_len(1)):
            col = db.vec_table(1, j)
            vectors: list[dict[str, Any]] = []
            entry_id = ""
            max_layer = 0
            graph = col.table(3)
            if graph is not None and graph.vec_len(0) > 0:
                entry_id = graph.string(1)
                max_layer = graph.i32(2)
                for k in range(graph.vec_len(0)):
                    node = graph.vec_table(0, k)
                    vectors.append(
                        {
                            "id": int(node.string(0) or "0"),
                            "elements": node.vec_f32(1),
                            "metadata": _parse_metadata(node.string(2)),
                            "deleted": node.boolean(3),
                        }
                    )
            else:
                # legacy snapshots carry only the flat vectors list
                # (rdb.fbs:64 "backwards compatibility")
                for k in range(col.vec_len(2)):
                    v = _parse_vector(col.vec_table(2, k))
                    v["deleted"] = False
                    vectors.append(v)
            cols[col.string(0)] = {
                "config": _parse_config(col.table(1)),
                "vectors": vectors,
                "entrypoint_id": entry_id,
                "max_layer": max_layer,
                "vector_count": col.i64(4),
                "deleted_count": col.i64(5),
                "created_at": col.i64(6),
                "updated_at": col.i64(7),
            }
        out["databases"][db.string(0)] = {
            "created_at": db.i64(2),
            "collections": cols,
        }
    return out


# ---------------------------------------------------------------------------
# engine import

_IMPORT_BATCH = 4096


def import_reference(
    engine,
    rdb_path: Optional[str] = None,
    aof_path: Optional[str] = None,
    index_type: str = "hnsw",
) -> dict[str, Any]:
    """Load a reference deployment's data directory into an Engine.

    Order matches the reference's startup recovery (persistence.go): RDB
    snapshot first, then the AOF tail replayed on top. Inserts are
    idempotent (apply_command skips existing ids), so an AOF that overlaps
    the snapshot is safe. Returns per-step counts."""
    from scintirete_tpu_torch.engine.database import make_command

    stats = {"databases": 0, "collections": 0, "vectors": 0,
             "deleted": 0, "aof_commands": 0}
    if rdb_path and os.path.exists(rdb_path):
        snap = read_rdb(rdb_path)
        for dbname, db_state in snap["databases"].items():
            if not engine.has_database(dbname):
                engine.create_database(dbname)
                stats["databases"] += 1
            for cname, col_state in db_state["collections"].items():
                cfg = dict(col_state["config"])
                cfg["index_type"] = index_type
                engine.apply_command(
                    make_command(
                        "CREATE_COLLECTION", dbname, cname, {"config": cfg}
                    )
                )
                stats["collections"] += 1
                col = engine.get_database(dbname).get_collection(cname)
                live = [v for v in col_state["vectors"] if not v["deleted"]]
                stats["deleted"] += len(col_state["vectors"]) - len(live)
                for s in range(0, len(live), _IMPORT_BATCH):
                    batch = live[s : s + _IMPORT_BATCH]
                    col.insert_with_ids(
                        [(v["id"], v["elements"], v["metadata"]) for v in batch]
                    )
                    stats["vectors"] += len(batch)
                # deleted nodes still hold their ids in the reference; keep
                # the auto-ID high-water above ALL imported ids, not just
                # live ones, so new inserts never collide with a tombstone
                if col_state["vectors"]:
                    top = max(v["id"] for v in col_state["vectors"])
                    col._next_id = max(col._next_id, top + 1)
    if aof_path and os.path.exists(aof_path):
        for cmd in iter_aof(aof_path):
            if cmd["command_type"] == "CREATE_COLLECTION":
                cmd["args"].setdefault("config", {})["index_type"] = index_type
            engine.apply_command(cmd)
            stats["aof_commands"] += 1
    return stats


# ---------------------------------------------------------------------------
# write side (reference-readable files; also the round-trip test harness)


def _wr_string(b: flatbuffers.Builder, s: str) -> int:
    return b.CreateString(s if s is not None else "")


def _wr_hnsw(b: flatbuffers.Builder, hnsw: dict[str, Any]) -> int:
    b.StartObject(5)
    b.PrependInt32Slot(0, int(hnsw.get("m", 0) or 0), 0)
    b.PrependInt32Slot(1, int(hnsw.get("ef_construction", 0) or 0), 0)
    b.PrependInt32Slot(2, int(hnsw.get("ef_search", 0) or 0), 0)
    b.PrependInt32Slot(3, int(hnsw.get("max_layers", 0) or 0), 0)
    b.PrependInt64Slot(4, int(hnsw.get("seed", 0) or 0), 0)
    return b.EndObject()


def _wr_config(b: flatbuffers.Builder, name: str, cfg: dict[str, Any]) -> int:
    hnsw_off = _wr_hnsw(b, cfg.get("hnsw", {}) or {})
    name_off = _wr_string(b, name)
    b.StartObject(3)
    b.PrependUOffsetTRelativeSlot(0, name_off, 0)
    b.PrependInt8Slot(1, int(cfg.get("metric", 0)), 0)
    b.PrependUOffsetTRelativeSlot(2, hnsw_off, 0)
    return b.EndObject()


def _wr_f32_vec(b: flatbuffers.Builder, elements) -> int:
    return b.CreateNumpyVector(np.ascontiguousarray(elements, np.float32))


def _wr_offset_vec(b: flatbuffers.Builder, offs: list[int]) -> int:
    b.StartVector(4, len(offs), 4)
    for off in reversed(offs):
        b.PrependUOffsetTRelative(off)
    return b.EndVector()


def _wr_vector(b: flatbuffers.Builder, vec: dict[str, Any]) -> int:
    elems_off = _wr_f32_vec(b, vec["elements"])
    meta_off = _wr_string(b, json.dumps(vec.get("metadata") or {}))
    id_off = _wr_string(b, str(vec["id"]))
    b.StartObject(3)
    b.PrependUOffsetTRelativeSlot(0, id_off, 0)
    b.PrependUOffsetTRelativeSlot(1, elems_off, 0)
    b.PrependUOffsetTRelativeSlot(2, meta_off, 0)
    return b.EndObject()


def write_aof_command(cmd: dict[str, Any]) -> bytes:
    """Logical command dict -> one AOFCommand FlatBuffer (no length prefix)."""
    b = flatbuffers.Builder(1024)
    name = cmd["command_type"]
    args = cmd.get("args", {})
    if name in ("CREATE_DATABASE", "DROP_DATABASE", "DROP_COLLECTION"):
        arg_name = args.get(
            "name", cmd["database"] if "DATABASE" in name else cmd["collection"]
        )
        name_off = _wr_string(b, arg_name)
        b.StartObject(1)
        b.PrependUOffsetTRelativeSlot(0, name_off, 0)
        args_off = b.EndObject()
    elif name == "CREATE_COLLECTION":
        cfg = args.get("config", {}) or {}
        cfg_off = _wr_config(b, cmd["collection"], cfg)
        name_off = _wr_string(b, args.get("name", cmd["collection"]))
        b.StartObject(2)
        b.PrependUOffsetTRelativeSlot(0, name_off, 0)
        b.PrependUOffsetTRelativeSlot(1, cfg_off, 0)
        args_off = b.EndObject()
    elif name == "INSERT_VECTORS":
        vec_offs = [_wr_vector(b, v) for v in args.get("vectors", [])]
        vecs_off = _wr_offset_vec(b, vec_offs)
        b.StartObject(1)
        b.PrependUOffsetTRelativeSlot(0, vecs_off, 0)
        args_off = b.EndObject()
    elif name == "DELETE_VECTORS":
        id_offs = [_wr_string(b, str(i)) for i in args.get("ids", [])]
        ids_off = _wr_offset_vec(b, id_offs)
        b.StartObject(1)
        b.PrependUOffsetTRelativeSlot(0, ids_off, 0)
        args_off = b.EndObject()
    else:
        raise ValueError(f"unsupported command type: {name}")
    db_off = _wr_string(b, cmd.get("database", ""))
    col_off = _wr_string(b, cmd.get("collection", ""))
    b.StartObject(6)
    b.PrependInt64Slot(0, int(cmd.get("timestamp", 0)), 0)
    b.PrependInt8Slot(1, _CMD_TYPES[name], 0)
    b.PrependInt8Slot(2, _ARGS_TAGS[name], 0)  # union type tag
    b.PrependUOffsetTRelativeSlot(3, args_off, 0)
    b.PrependUOffsetTRelativeSlot(4, db_off, 0)
    b.PrependUOffsetTRelativeSlot(5, col_off, 0)
    root = b.EndObject()
    b.Finish(root)
    return bytes(b.Output())


def write_aof(commands, path: str) -> int:
    """Write logical commands as a reference-format AOF file."""
    n = 0
    with open(path, "wb") as f:
        for cmd in commands:
            data = write_aof_command(cmd)
            f.write(struct.pack("<I", len(data)))
            f.write(data)
            n += 1
    return n


def _wr_node(
    b: flatbuffers.Builder,
    vid: int,
    elements: np.ndarray,
    metadata: Optional[dict],
    deleted: bool,
    connections: list[tuple[int, list[int]]],
) -> int:
    conn_offs = []
    for layer, nbr_ids in connections:
        id_offs = [_wr_string(b, str(i)) for i in nbr_ids]
        ids_off = _wr_offset_vec(b, id_offs)
        b.StartObject(2)
        b.PrependInt32Slot(0, layer, 0)
        b.PrependUOffsetTRelativeSlot(1, ids_off, 0)
        conn_offs.append(b.EndObject())
    conns_off = _wr_offset_vec(b, conn_offs) if conn_offs else None
    elems_off = _wr_f32_vec(b, elements)
    meta_off = _wr_string(b, json.dumps(metadata or {}))
    id_off = _wr_string(b, str(vid))
    b.StartObject(6)
    b.PrependUOffsetTRelativeSlot(0, id_off, 0)
    b.PrependUOffsetTRelativeSlot(1, elems_off, 0)
    b.PrependUOffsetTRelativeSlot(2, meta_off, 0)
    b.PrependBoolSlot(3, deleted, False)
    if conns_off is not None:
        b.PrependUOffsetTRelativeSlot(4, conns_off, 0)
    b.PrependInt32Slot(5, len(connections) - 1 if connections else 0, 0)
    return b.EndObject()


def export_rdb(engine, path: str) -> dict[str, Any]:
    """Write the engine's current state as a reference-format RDBSnapshot.

    HNSW collections carry full layer_connections (reference restore needs
    them, database.go:461-463); flat collections carry vectors only
    (max_layer 0, no edges — see module docstring)."""
    b = flatbuffers.Builder(1 << 20)
    db_offs = []
    stats = {"databases": 0, "collections": 0, "vectors": 0}
    for dbname in engine.list_databases():
        db = engine.get_database(dbname)
        col_offs = []
        for col in db.collections():
            with col._rw.read():
                index = col._index
                node_offs = []
                entry_id = ""
                gmax_layer = 0
                live = 0
                first_live_id = None
                if index is not None:
                    store = getattr(index, "store", None)
                    id_list = sorted(index.id_to_slot)
                    for vid in id_list:
                        slot = index.id_to_slot[vid]
                        if store is not None:
                            elements = store.vectors[slot]
                            deleted = bool(store.deleted[slot])
                            level = int(store.levels[slot])
                            conns = []
                            for layer in range(max(level, 0) + 1):
                                nbrs = store.get_neighbors(slot, layer)
                                nbr_ids = [
                                    int(index.slot_to_id[s])
                                    for s in np.asarray(nbrs)
                                    if s >= 0
                                ]
                                conns.append((layer, nbr_ids))
                        else:
                            elements = index.vectors[slot]
                            deleted = bool(index.deleted[slot])
                            conns = []
                        if not deleted:
                            live += 1
                            if first_live_id is None:
                                first_live_id = vid
                        node_offs.append(
                            _wr_node(
                                b, vid, elements,
                                col._metadata.get(vid), deleted, conns,
                            )
                        )
                    if store is not None and store.entry_slot >= 0:
                        entry_id = str(int(index.slot_to_id[store.entry_slot]))
                        gmax_layer = max(int(store.max_layer), 0)
                if not entry_id:
                    # the reference hard-errors on ParseUint("") at restore
                    # (rdb.go:1080) and fails the WHOLE file — flat and
                    # empty collections must still emit a parseable id.
                    # The reference's own export of an empty graph writes
                    # the uint64 zero value ("%d" of EntryPoint, rdb.go:
                    # 1020), so "0" matches its wire behavior; for flat
                    # collections with data, point at the first live id.
                    entry_id = (
                        str(first_live_id) if first_live_id is not None
                        else "0"
                    )
                nodes_off = _wr_offset_vec(b, node_offs)
                entry_off = _wr_string(b, entry_id)
                b.StartObject(4)
                b.PrependUOffsetTRelativeSlot(0, nodes_off, 0)
                b.PrependUOffsetTRelativeSlot(1, entry_off, 0)
                b.PrependInt32Slot(2, gmax_layer, 0)
                b.PrependInt32Slot(3, len(node_offs), 0)
                graph_off = b.EndObject()
                import dataclasses as dc

                cfg_off = _wr_config(
                    b,
                    col.name,
                    {
                        "metric": int(col.config.metric),
                        "hnsw": dc.asdict(col.config.hnsw),
                    },
                )
                cname_off = _wr_string(b, col.name)
                b.StartObject(8)
                b.PrependUOffsetTRelativeSlot(0, cname_off, 0)
                b.PrependUOffsetTRelativeSlot(1, cfg_off, 0)
                # slot 2 (legacy vectors) intentionally absent: hnsw_graph
                # is authoritative and duplicating vectors doubles the file
                b.PrependUOffsetTRelativeSlot(3, graph_off, 0)
                b.PrependInt64Slot(4, live, 0)
                b.PrependInt64Slot(5, len(node_offs) - live, 0)
                b.PrependInt64Slot(6, int(col.created_at), 0)
                b.PrependInt64Slot(7, int(col.updated_at), 0)
                col_offs.append(b.EndObject())
                stats["collections"] += 1
                stats["vectors"] += len(node_offs)
        cols_off = _wr_offset_vec(b, col_offs)
        dbname_off = _wr_string(b, dbname)
        b.StartObject(3)
        b.PrependUOffsetTRelativeSlot(0, dbname_off, 0)
        b.PrependUOffsetTRelativeSlot(1, cols_off, 0)
        b.PrependInt64Slot(2, int(db.created_at), 0)
        db_offs.append(b.EndObject())
        stats["databases"] += 1
    dbs_off = _wr_offset_vec(b, db_offs)
    import time as _time

    meta_off = _wr_string(b, json.dumps({"created_by": "scintirete-tpu"}))
    ver_off = _wr_string(b, "1.0")
    b.StartObject(4)
    b.PrependUOffsetTRelativeSlot(0, ver_off, 0)
    b.PrependInt64Slot(1, int(_time.time()), 0)
    b.PrependUOffsetTRelativeSlot(2, dbs_off, 0)
    b.PrependUOffsetTRelativeSlot(3, meta_off, 0)
    root = b.EndObject()
    b.Finish(root)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b.Output())
    os.replace(tmp, path)
    return stats
