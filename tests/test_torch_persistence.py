"""The port's durability layer (`scintirete_tpu_torch.persistence` and the
engine's AOF bridge) against the JAX package's, on the CPU.

- The port's serde (msgpack with the ndarray extension) gives the JAX
  package's bytes and objects back, and raises on malformed input.
- Both packages' AOFLogger and RDBManager write the same bytes for the
  same commands and states, and a state restored in either exports the
  same dict.
- A data directory (RDB + AOF tail) written by either package recovers in
  the other with the same vectors, metadata and search results, for HNSW
  and flat collections at three metrics.
- The port's counterparts of `tests/test_persistence.py`'s classes.

Collections are small and built on the host path (`use_device=False`),
except the flat ones the port recovers through its torch path on the CPU.
"""

import dataclasses
import json
import math
import os
import shutil
import struct
import time

import numpy as np
import pytest

from scintirete_tpu import engine as jengine
from scintirete_tpu import persistence as jpersistence
from scintirete_tpu import types as jtypes
from scintirete_tpu.persistence import serde as jserde
from scintirete_tpu_torch import engine as tengine
from scintirete_tpu_torch import persistence as tpersistence
from scintirete_tpu_torch import types as ttypes
from scintirete_tpu_torch.engine.database import CMD_CREATE_DATABASE, make_command
from scintirete_tpu_torch.errors import ErrorCode, ScintireteError
from scintirete_tpu_torch.persistence import (
    AOFLogger,
    BackupManager,
    PersistenceManager,
    RDBManager,
    serde,
)
from scintirete_tpu_torch.types import (
    CollectionConfig,
    DistanceMetric,
    HNSWParams,
    SearchParams,
)


def same(a, b) -> bool:
    """Deep equality with ndarrays (dtype, shape, values, NaN = NaN) and
    NaN floats."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


# ----- serde: msgpack with the ndarray extension -----

_rng = np.random.default_rng(3)
CASES = {f"nd_{d}": (_rng.standard_normal((7, 5)) * 50).astype(d)
         for d in ("<f4", "<i4", "i1", "<u8", "?")}
CASES["nd_strided"] = np.arange(60, dtype=np.float32).reshape(6, 10)[:, ::3]
CASES["nd_transposed"] = np.arange(24, dtype=np.int32).reshape(4, 6).T
CASES["nd_scalar"] = np.array(3.5, np.float32)
CASES["nd_empty"] = np.zeros((0, 8), np.float32)
CASES.update({f"np_{type(v).__name__}_{i}": v for i, v in enumerate(
    [np.int8(-5), np.int32(70000), np.int64(-2**63), np.uint64(2**64 - 1),
     np.float32(1.5), np.float32(np.nan), np.float16(0.1),
     np.bool_(True), np.bool_(False)]
)})
CASES["intenum"] = DistanceMetric.COSINE
CASES["floats_4096x128"] = (
    _rng.standard_normal((4096, 128)).astype(np.float32).tolist()
)
CASES["insert_record"] = make_command(
    "INSERT_VECTORS", "db", "c",
    {"vectors": [
        {"id": i + 1, "elements": v.tolist(),
         "metadata": {"i": i, "tag": "é" * i, "__nd__": True}}
        for i, v in enumerate(_rng.standard_normal((40, 24)).astype(np.float32))
    ]},
    timestamp=1700000000.25,
)
CASES["nested"] = {"a": [None, True, False, {"b": [b"x", -7, 2.5]}],
                   "n": {"__nd__": True, "d": "<f4", "s": [1], "b": b"\x00"},
                   1: "int key"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_serde_is_the_jax_packages(name):
    """The same bytes as the JAX package's serde, and the same objects
    back from them."""
    data = jserde.dumps(CASES[name])
    assert serde.dumps(CASES[name]) == data
    assert same(serde.loads(data), jserde.loads(data))


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("nd_")])
def test_serde_round_trips_ndarrays(name):
    arr = CASES[name]
    back = serde.loads(serde.dumps({"a": arr}))["a"]
    assert back.flags.c_contiguous and back.flags.writeable
    assert same(back, np.ascontiguousarray(arr))


def test_serde_keeps_metadata_that_looks_like_an_array():
    """The ndarray hook checks the whole encoding: user metadata holding
    an "__nd__" key stays a dict."""
    for meta in ({"__nd__": True}, {"__nd__": True, "d": "<f4", "s": [1],
                                    "b": "not bytes"},
                 {"__nd__": True, "d": "<f4", "s": [3], "b": b"\x00"}):
        assert serde.loads(serde.dumps({"m": meta}))["m"] == meta


@pytest.mark.parametrize("value", [object(), {1, 2}, 1j, [object()]])
def test_serde_unknown_type_raises(value):
    with pytest.raises(TypeError):
        serde.dumps(value)


def test_serde_truncated_input_raises():
    data = serde.dumps(CASES["insert_record"])
    for cut in list(range(0, 64)) + list(range(64, len(data), 97)):
        with pytest.raises(ValueError):
            serde.loads(data[:cut])


@pytest.mark.parametrize("data", [
    b"\xc1",  # reserved
    b"\x01\x02",  # trailing data
    b"\x92\x01",  # array short of its elements
    b"\xa3ab",  # str short of its bytes
    b"\xa2\xff\xfe",  # not UTF-8
    b"\xdc\x00\x20" + b"\xcb" + b"\x00" * 8 * 2,  # float run cut short
])
def test_serde_malformed_input_raises(data):
    with pytest.raises(ValueError):
        serde.loads(data)


# ----- the same bytes from both packages -----


def _sample_commands():
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((30, 16)).astype(np.float32)
    cfg = {"metric": 2, "hnsw": dataclasses.asdict(HNSWParams(m=8, seed=3)),
           "device_dtype": "float32", "index_type": "hnsw"}
    return [
        ("CREATE_DATABASE", "db", "", None),
        ("CREATE_COLLECTION", "db", "c", {"config": cfg}),
        ("INSERT_VECTORS", "db", "c", {"vectors": [
            {"id": i + 1, "elements": v.tolist(),
             "metadata": {"i": i} if i % 3 else None}
            for i, v in enumerate(vecs[:20])
        ]}),
        ("INSERT_VECTORS", "db", "c", {"vectors": [
            {"id": 100 + i, "elements": v, "metadata": {"nd": v[:2]}}
            for i, v in enumerate(vecs[20:])
        ]}),
        ("DELETE_VECTORS", "db", "c", {"ids": [1, 2, 2**40]}),
        ("DROP_COLLECTION", "db", "c", None),
        ("DROP_DATABASE", "db", "", None),
    ]


@pytest.mark.parametrize("strategy", ["always", "everysec", "no"])
def test_aof_files_are_the_same_bytes(tmp_path, strategy):
    paths = []
    for pkg, mk in ((jpersistence, jengine.database.make_command),
                    (tpersistence, make_command)):
        path = str(tmp_path / f"{pkg.__name__}.aof")
        log = pkg.AOFLogger(path, strategy)
        for i, (ctype, db, col, args) in enumerate(_sample_commands()):
            log.write_command(mk(ctype, db, col, args, timestamp=1e9 + i))
        log.close()
        paths.append(path)
    a, b = (open(p, "rb").read() for p in paths)
    assert len(a) > 0 and a == b
    seen = []
    AOFLogger(paths[0], "no").replay(seen.append)
    assert [c["command_type"] for c in seen] == [
        c[0] for c in _sample_commands()
    ]


def _jax_engine_with_collections(rng, n=50, dim=8):
    """A JAX engine (host path) with an HNSW, a flat and an empty
    collection, metadata and tombstones."""
    engine = jengine.Engine(use_device=False)
    db = engine.create_database("db")
    for name, kind, metric in (("h", "hnsw", 1), ("f", "flat", 3)):
        col = db.create_collection(jtypes.CollectionConfig(
            name=name, metric=jtypes.DistanceMetric(metric), index_type=kind,
            hnsw=jtypes.HNSWParams(m=8, ef_construction=40, seed=7),
        ))
        data = rng.standard_normal((n, dim)).astype(np.float32)
        ids = col.insert([(v, {"i": i} if i % 2 else None)
                          for i, v in enumerate(data)])
        col.delete(ids[:4])
    db.create_collection(jtypes.CollectionConfig(name="e"))
    engine.create_database("empty")
    return engine


def _strip(state):
    """A state without its clock readings (timestamp, created_at)."""
    if isinstance(state, dict):
        return {k: _strip(v) for k, v in state.items()
                if k not in ("timestamp", "created_at")}
    return state


def test_rdb_files_and_restored_states_are_the_same(tmp_path, rng):
    state = _jax_engine_with_collections(rng).export_state()
    jpath, tpath = str(tmp_path / "j.rdb"), str(tmp_path / "t.rdb")
    jpersistence.RDBManager(jpath).save(state)
    RDBManager(tpath).save(state)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()

    loaded = RDBManager(jpath).load()
    assert same(loaded, jpersistence.RDBManager(tpath).load())
    jeng = jengine.Engine(use_device=False)
    jeng.restore_state(loaded)
    teng = tengine.Engine(use_device=False, device="cpu")
    teng.restore_state(loaded)
    jstate, tstate = jeng.export_state(), teng.export_state()
    assert same(_strip(jstate), _strip(tstate))
    # with the clock readings equal, the port's export is the same bytes
    tstate["timestamp"] = jstate["timestamp"]
    for name, db in tstate["databases"].items():
        db["created_at"] = jstate["databases"][name]["created_at"]
    assert serde.dumps(tstate) == jserde.dumps(jstate)


def test_make_command_is_the_same(tmp_path):
    for ctype, db, col, args in _sample_commands():
        assert same(make_command(ctype, db, col, args, timestamp=5.0),
                    jengine.database.make_command(ctype, db, col, args,
                                                  timestamp=5.0))


# ----- recovery across the two packages -----


class _Pkg:
    def __init__(self, name):
        self.name = name
        self.port = name == "port"
        self.engine = tengine if self.port else jengine
        self.persistence = tpersistence if self.port else jpersistence
        self.types = ttypes if self.port else jtypes

    def new_engine(self, use_device=False):
        if self.port:
            return tengine.Engine(use_device=use_device, device="cpu")
        return jengine.Engine(use_device=False)


PKGS = {"jax": _Pkg("jax"), "port": _Pkg("port")}


def _write_data_dir(pkg, path, index_type, metric, seed):
    """RDB of a populated collection, then an AOF tail: an insert, a
    delete and a drop (as the server logs them)."""
    rng = np.random.default_rng(seed)
    engine = pkg.new_engine()
    pm = pkg.persistence.PersistenceManager(engine, path)
    t = pkg.types
    db = engine.create_database("db")
    pm.log_create_database("db")
    hnsw = t.HNSWParams(m=8, ef_construction=40, ef_search=30, seed=5)
    cols = {}
    for name in ("c", "gone"):
        cols[name] = db.create_collection(t.CollectionConfig(
            name=name, metric=t.DistanceMetric(metric), hnsw=hnsw,
            index_type=index_type,
        ))
        pm.log_create_collection("db", name, {
            "metric": metric, "hnsw": dataclasses.asdict(hnsw),
            "device_dtype": "float32", "index_type": index_type,
        })
    data = rng.standard_normal((80, 8)).astype(np.float32)
    written = []

    def insert(col_name, rows):
        pairs = [(v.tolist(), {"row": len(written) + i, "tag": "é"})
                 for i, v in enumerate(rows)]
        ids = cols[col_name].insert(pairs)
        pm.log_insert_vectors("db", col_name, [
            {"id": vid, "elements": e, "metadata": m}
            for vid, (e, m) in zip(ids, pairs)
        ])
        return ids

    written += insert("c", data[:60])
    insert("gone", data[:10])
    cols["c"].delete(written[:3])
    pm.log_delete_vectors("db", "c", written[:3])
    pm.save_snapshot()
    written += insert("c", data[60:])  # the tail
    cols["c"].delete([written[5], written[65]])
    pm.log_delete_vectors("db", "c", [written[5], written[65]])
    db.drop_collection("gone")
    pm.log_drop_collection("db", "gone")
    pm.stop()
    queries = data[::4] + 0.05 * rng.standard_normal((20, 8)).astype(np.float32)
    return engine, written, queries


def _recover(pkg, path, use_device=False):
    engine = pkg.new_engine(use_device)
    pm = pkg.persistence.PersistenceManager(engine, path)
    report = pm.recover()
    pm.stop()
    assert report["rdb_loaded"] is True
    assert report["aof_commands"] == 3 and report["degraded"] == []
    return engine


def _untied(dists, tol=1e-5):
    d = np.asarray(dists, np.float64)
    return bool(np.all(np.diff(d) > tol * np.maximum(1.0, np.abs(d[1:]))))


@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("index_type", ["hnsw", "flat"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_recovery_across_packages(tmp_path, writer, reader, index_type, metric):
    path = str(tmp_path / "data")
    live, ids, queries = _write_data_dir(PKGS[writer], path, index_type,
                                         metric, seed=metric)
    # the writer's own recovery is the reference for the reader's
    want = _recover(PKGS[writer], str(tmp_path / "data"))
    # the port reads flat collections through its torch path on the CPU
    use_device = index_type == "flat" and reader == "port"
    got = _recover(PKGS[reader], path, use_device)
    assert got.list_databases() == ["db"]
    assert got.get_database("db").list_collections() == ["c"]
    cols = [e.get_database("db").get_collection("c")
            for e in (live, want, got)]
    for vid in ids:
        rows = [c.get_multiple([vid]) for c in cols]
        assert [[(v.id, v.elements, v.metadata) for v in r] for r in rows[1:]
                ] == [[(v.id, v.elements, v.metadata) for v in rows[0]]] * 2
    assert cols[2].count() == cols[0].count() == len(ids) - 5
    sp = SearchParams(top_k=5, ef_search=30)
    res_want = cols[1].search_batch(queries, sp)
    res_got = cols[2].search_batch(queries, sp)
    compared = 0
    for rw, rg in zip(res_want, res_got):
        if _untied([r.distance for r in rw]):
            assert [r.id for r in rg] == [r.id for r in rw]
            # the port's torch path sums in another order than numpy
            # (tests/test_torch_flat.py's tolerance); the host paths agree
            np.testing.assert_allclose([r.distance for r in rg],
                                       [r.distance for r in rw],
                                       rtol=1e-4, atol=1e-5)
            compared += 1
    assert compared >= len(queries) // 2
    # new inserts continue past the recovered high-water mark
    assert cols[2].insert([(queries[0], None)]) == [max(ids) + 1]


def test_restored_graph_draws_levels_from_the_seed():
    """Neither package keeps the level generator's state in a snapshot: a
    restored graph draws the levels of its next inserts from the seed's
    start, as a fresh one does, and both packages draw the same."""
    from scintirete_tpu.index.hnsw import HNSWIndex as JaxHNSWIndex
    from scintirete_tpu_torch.index.hnsw import HNSWIndex

    data = np.random.default_rng(2).standard_normal((40, 8)).astype(np.float32)
    live = HNSWIndex(8, HNSWParams(m=8, ef_construction=40, seed=9),
                     DistanceMetric.L2, use_device=False, device="cpu")
    live.bulk_insert(list(range(1, 41)), data)
    state = live.export_graph_state()
    port = HNSWIndex.import_graph_state(state, use_device=False, device="cpu")
    jax = JaxHNSWIndex.import_graph_state(state, use_device=False)
    fresh = np.random.default_rng(9)
    want = fresh.random(8)
    assert np.array_equal(port.store.rng.random(8), want)
    assert np.array_equal(jax.store.rng.random(8), want)
    assert not np.array_equal(live.store.rng.random(8), want)


# ----- the port's counterparts of tests/test_persistence.py -----

CFG = lambda name="c": CollectionConfig(  # noqa: E731
    name=name,
    metric=DistanceMetric.L2,
    hnsw=HNSWParams(m=8, ef_construction=40, ef_search=30, seed=5),
)


def make_manager(tmp_path, engine=None, **kw):
    engine = engine or tengine.Engine(use_device=False, device="cpu")
    return engine, PersistenceManager(engine, str(tmp_path / "data"), **kw)


def populate(engine, rng, n=30):
    db = engine.create_database("db")
    col = db.create_collection(CFG())
    data = rng.standard_normal((n, 8)).astype(np.float32)
    ids = col.insert([(v, {"i": i}) for i, v in enumerate(data)])
    return col, data, ids


def log_collection(pm, ids, data, with_meta=True):
    pm.log_create_database("db")
    pm.log_create_collection(
        "db", "c", {"metric": 1, "hnsw": {"m": 8, "seed": 5}}
    )
    pm.log_insert_vectors("db", "c", [
        {"id": vid, "elements": data[i].tolist(),
         "metadata": {"i": i} if with_meta else None}
        for i, vid in enumerate(ids)
    ])


class TestAOF:
    @pytest.mark.parametrize("strategy", ["always", "everysec", "no"])
    def test_write_replay_roundtrip(self, tmp_path, strategy):
        path = str(tmp_path / "a.aof")
        log = AOFLogger(path, strategy)
        cmds = [
            make_command(CMD_CREATE_DATABASE, f"db{i}", timestamp=float(i))
            for i in range(5)
        ]
        for c in cmds:
            log.write_command(c)
        log.flush()
        seen = []
        log.replay(seen.append)
        assert [c["database"] for c in seen] == [f"db{i}" for i in range(5)]
        assert seen[0]["timestamp"] == 0.0
        log.close()

    def test_replay_survives_reopen(self, tmp_path):
        path = str(tmp_path / "a.aof")
        log = AOFLogger(path, "always")
        log.write_command(make_command(CMD_CREATE_DATABASE, "db"))
        log.close()
        log2 = AOFLogger(path, "always")
        seen = []
        log2.replay(seen.append)
        assert len(seen) == 1
        log2.close()

    def test_truncate(self, tmp_path):
        log = AOFLogger(str(tmp_path / "a.aof"), "always")
        log.write_command(make_command(CMD_CREATE_DATABASE, "db"))
        assert log.size_bytes() > 0
        log.truncate()
        assert log.size_bytes() == 0
        seen = []
        log.replay(seen.append)
        assert seen == []
        log.close()

    def test_rewrite_atomic_replaces(self, tmp_path):
        log = AOFLogger(str(tmp_path / "a.aof"), "always")
        for i in range(10):
            log.write_command(make_command(CMD_CREATE_DATABASE, f"x{i}"))
        log.rewrite([make_command(CMD_CREATE_DATABASE, "compacted")])
        assert not os.path.exists(str(tmp_path / "a.aof.rewrite.tmp"))
        seen = []
        log.replay(seen.append)
        assert [c["database"] for c in seen] == ["compacted"]
        log.write_command(make_command(CMD_CREATE_DATABASE, "after"))
        log.flush()
        seen = []
        log.replay(seen.append)
        assert len(seen) == 2
        log.close()

    @pytest.mark.parametrize("damage", ["length", "body", "prefix"])
    def test_corrupt_record_rejected(self, tmp_path, damage):
        path = str(tmp_path / "a.aof")
        log = AOFLogger(path, "always")
        log.write_command(make_command(CMD_CREATE_DATABASE, "db"))
        log.close()
        good = open(path, "rb").read()
        bad = {
            "length": struct.pack("<I", 2**31) + b"xx",  # absurd length
            "body": good[:-3],  # the record body chopped
            "prefix": good + b"\x01",  # a torn length prefix
        }[damage]
        open(path, "wb").write(bad)
        log2 = AOFLogger(path, "no")
        with pytest.raises(ScintireteError) as exc:
            log2.replay(lambda c: None)
        assert exc.value.code == ErrorCode.CORRUPTED_DATA
        log2.close()

    def test_record_size_cap(self, tmp_path, monkeypatch):
        from scintirete_tpu_torch.persistence import aof

        monkeypatch.setattr(aof, "MAX_RECORD_BYTES", 64)
        log = AOFLogger(str(tmp_path / "a.aof"), "always")
        with pytest.raises(ScintireteError) as exc:
            log.write_command(make_command(
                CMD_CREATE_DATABASE, "x" * 100
            ))
        assert exc.value.code == ErrorCode.PERSISTENCE_FAILED
        log.close()

    def test_metadata_preserved(self, tmp_path):
        # the reference drops AOF metadata (aof.go:530-535); we must not
        log = AOFLogger(str(tmp_path / "a.aof"), "always")
        cmd = make_command(
            "INSERT_VECTORS", "db", "c",
            {"vectors": [{"id": 1, "elements": [1.0, 2.0],
                          "metadata": {"k": "v"}}]},
        )
        log.write_command(cmd)
        seen = []
        log.replay(seen.append)
        assert seen[0]["args"]["vectors"][0]["metadata"] == {"k": "v"}
        log.close()

    def test_everysec_background_flush(self, tmp_path):
        log = AOFLogger(str(tmp_path / "a.aof"), "everysec")
        log.write_command(make_command(CMD_CREATE_DATABASE, "db"))
        time.sleep(1.5)
        assert os.path.getsize(str(tmp_path / "a.aof")) > 0
        log.close()


class TestRDB:
    @pytest.mark.parametrize("index_type", ["hnsw", "flat"])
    def test_save_load_roundtrip(self, tmp_path, rng, index_type):
        engine = tengine.Engine(device="cpu")
        col = engine.create_database("db").create_collection(
            dataclasses.replace(CFG(), index_type=index_type)
        )
        data = rng.standard_normal((30, 8)).astype(np.float32)
        col.insert([(v, {"i": i}) for i, v in enumerate(data)])
        rdb = RDBManager(str(tmp_path / "v.rdb"))
        rdb.save(engine.export_state())
        assert not os.path.exists(str(tmp_path / "v.rdb.tmp"))
        engine2 = tengine.Engine(device="cpu")
        engine2.restore_state(rdb.load())
        col2 = engine2.get_database("db").get_collection("c")
        assert col2.count() == 30
        sp = SearchParams(top_k=5)
        for q in data[::7]:
            assert ([(r.id, r.distance) for r in col.search(q, sp)]
                    == [(r.id, r.distance) for r in col2.search(q, sp)])

    def test_missing_file_is_none(self, tmp_path):
        assert RDBManager(str(tmp_path / "none.rdb")).load() is None

    @pytest.mark.parametrize("content", [b"garbage-not-an-rdb",
                                         b"STRDB1\n\xc1", b"STRDB1\n\x91"])
    def test_bad_file_rejected(self, tmp_path, content):
        path = tmp_path / "v.rdb"
        path.write_bytes(content)
        with pytest.raises(ScintireteError) as exc:
            RDBManager(str(path)).load()
        assert exc.value.code == ErrorCode.CORRUPTED_DATA

    def test_validation_rejects_inconsistent(self, rng):
        engine = tengine.Engine(use_device=False, device="cpu")
        populate(engine, rng, n=5)
        state = engine.export_state()
        graph = state["databases"]["db"]["collections"]["c"]["graph"]
        graph["count"] = 999  # inconsistent with array lengths
        with pytest.raises(ScintireteError):
            RDBManager.validate(state)

    def test_backups(self, tmp_path, rng):
        engine = tengine.Engine(use_device=False, device="cpu")
        populate(engine, rng, n=3)
        rdb = RDBManager(str(tmp_path / "v.rdb"))
        rdb.save(engine.export_state())
        bm = BackupManager(rdb)
        b1 = bm.create_backup()
        b2 = bm.create_backup()
        assert bm.list_backups() == sorted([b1, b2])
        os.remove(rdb.path)
        bm.restore_backup(b1)
        assert rdb.load() is not None


class TestManagerIntegration:
    def test_end_to_end_recovery_aof_only(self, tmp_path, rng):
        engine, pm = make_manager(tmp_path)
        col, data, ids = populate(engine, rng, n=10)
        log_collection(pm, ids, data)
        col.delete(ids[:2])
        pm.log_delete_vectors("db", "c", ids[:2])
        pm.stop()

        engine2, pm2 = make_manager(tmp_path)
        result = pm2.recover()
        assert result["rdb_loaded"] is False
        assert result["aof_commands"] == 4
        col2 = engine2.get_database("db").get_collection("c")
        assert col2.count() == 8
        assert col2.get(ids[5]).metadata == {"i": 5}
        pm2.stop()

    def test_snapshot_truncates_aof_and_combined_recovery(self, tmp_path, rng):
        engine, pm = make_manager(tmp_path)
        col, data, ids = populate(engine, rng, n=20)
        log_collection(pm, ids, data)
        pm.save_snapshot()
        assert pm.aof.size_bytes() == 0  # snapshot truncated the AOF
        tail = rng.standard_normal((3, 8)).astype(np.float32)
        tail_ids = col.insert([(v, None) for v in tail])
        pm.log_insert_vectors("db", "c", [
            {"id": vid, "elements": tail[i].tolist()}
            for i, vid in enumerate(tail_ids)
        ])
        pm.stop()

        engine2, pm2 = make_manager(tmp_path)
        result = pm2.recover()
        assert result["rdb_loaded"] is True
        assert result["aof_commands"] == 1
        col2 = engine2.get_database("db").get_collection("c")
        assert col2.count() == 23
        r1 = col.search(data[0], SearchParams(top_k=5))
        r2 = col2.search(data[0], SearchParams(top_k=5))
        assert [x.id for x in r1] == [x.id for x in r2]
        pm2.stop()

    def test_replayed_insert_skips_existing_ids(self, tmp_path, rng):
        """At-least-once replay: an insert both in the snapshot and in the
        AOF tail is applied once."""
        engine, pm = make_manager(tmp_path)
        col, data, ids = populate(engine, rng, n=6)
        pm.save_snapshot()
        log_collection(pm, ids, data)  # the same inserts again in the tail
        pm.stop()
        engine2, pm2 = make_manager(tmp_path)
        result = pm2.recover()
        assert result["aof_commands"] == 3 and not result["degraded"]
        col2 = engine2.get_database("db").get_collection("c")
        assert col2.count() == 6 and col2.info().deleted_count == 0
        pm2.stop()

    def test_smart_snapshot_gate(self, tmp_path):
        engine, pm = make_manager(
            tmp_path, snapshot_min_commands=5, snapshot_max_age_seconds=9999
        )
        engine.create_database("db")
        pm.log_create_database("db")
        assert pm.maybe_snapshot() is False  # 1 < 5 commands, young
        for i in range(5):
            pm.log_create_database(f"x{i}")  # log only; gate counts commands
        assert pm.maybe_snapshot() is True
        assert pm.maybe_snapshot() is False  # no longer dirty
        pm.stop()

    def test_smart_rewrite_gate(self, tmp_path, rng):
        engine, pm = make_manager(tmp_path, aof_rewrite_size_bytes=200)
        col, data, ids = populate(engine, rng, n=250)
        for i in range(50):
            pm.log_create_database(f"noise{i}")
        pm.aof.flush()
        assert pm.aof.size_bytes() > 200
        assert pm.maybe_rewrite_aof() is True
        assert pm.maybe_rewrite_aof() is False  # has not grown by half
        seen = []
        pm.aof.replay(seen.append)
        # CREATE_DATABASE, CREATE_COLLECTION and the 250 live vectors in
        # records of 100
        assert [c["command_type"] for c in seen] == (
            ["CREATE_DATABASE", "CREATE_COLLECTION"] + ["INSERT_VECTORS"] * 3
        )
        assert [len(c["args"]["vectors"]) for c in seen[2:]] == [100, 100, 50]
        assert seen[1]["args"]["next_id"] == 251
        pm.stop()

    def test_rewrite_after_snapshot_preserves_deletes(self, tmp_path, rng):
        """A rewritten AOF is a full-state stream; replaying it on top of a
        stale RDB must not resurrect rows deleted since the snapshot."""
        engine, pm = make_manager(tmp_path, aof_rewrite_size_bytes=1)
        col, data, ids = populate(engine, rng, n=5)
        log_collection(pm, ids, data)
        pm.save_snapshot()
        assert pm.rdb.exists()
        col.delete([ids[0]])
        pm.log_delete_vectors("db", "c", [ids[0]])
        pm.aof.flush()
        assert pm.maybe_rewrite_aof() is True
        pm.stop()

        engine2, pm2 = make_manager(tmp_path)
        pm2.recover()
        col2 = engine2.get_database("db").get_collection("c")
        assert col2.count() == 4
        with pytest.raises(ScintireteError):
            col2.get(ids[0])
        pm2.stop()

    def test_background_tasks_fire(self, tmp_path):
        engine, pm = make_manager(
            tmp_path,
            rdb_interval_seconds=0.2,
            snapshot_min_commands=1,
            snapshot_max_age_seconds=0.0,
            aof_rewrite_check_seconds=60,
        )
        engine.create_database("db")
        pm.log_create_database("db")
        pm.start_background_tasks()
        deadline = time.time() + 5
        while time.time() < deadline and pm.stats()["snapshots"] == 0:
            time.sleep(0.05)
        pm.stop()
        assert pm.stats()["snapshots"] >= 1
        assert pm.rdb.exists()

    def test_bgsave_async(self, tmp_path, rng):
        engine, pm = make_manager(tmp_path)
        populate(engine, rng, n=5)
        t = pm.background_save()
        t.join(timeout=10)
        assert pm.rdb.exists()
        pm.stop()

    def test_stats(self, tmp_path):
        engine, pm = make_manager(tmp_path)
        engine.create_database("db")
        pm.log_create_database("db")
        st_ = pm.stats()
        assert st_["aof_writes"] == 1
        assert st_["dirty_commands"] == 1
        pm.stop()


class TestDegradedRecovery:
    """Corruption policy: warn + preserve + salvage instead of crash
    (reference degraded path: persistence.go:185-305)."""

    def _write_and_stop(self, tmp_path, rng, n=10):
        engine, pm = make_manager(tmp_path)
        col, data, ids = populate(engine, rng, n=n)
        log_collection(pm, ids, data)
        pm.stop()
        return ids

    def test_corrupt_aof_tail_salvaged(self, tmp_path, rng):
        from scintirete_tpu_torch.observability import StructuredLogger
        import io

        ids = self._write_and_stop(tmp_path, rng)
        aof_path = tmp_path / "data" / "appendonly.aof"
        good = aof_path.read_bytes()
        # crash mid-append: a record whose body was cut off
        aof_path.write_bytes(good + struct.pack("<I", 500) + b"partial")

        stream = io.StringIO()
        engine2, pm2 = make_manager(
            tmp_path, logger=StructuredLogger(stream=stream)
        )
        result = pm2.recover()
        assert result["aof_commands"] == 3  # all good records replayed
        assert result["degraded"] and result["degraded"][0]["source"] == "aof"
        detail = result["degraded"][0]
        assert detail["dropped_bytes"] == 4 + len(b"partial")
        assert os.path.exists(detail["preserved_as"])  # original kept
        assert aof_path.read_bytes() == good  # live log valid again
        logged = [json.loads(line) for line in stream.getvalue().splitlines()]
        assert [r["msg"] for r in logged] == [
            "corrupt AOF tail salvaged", "recovery complete"
        ]
        col2 = engine2.get_database("db").get_collection("c")
        assert col2.count() == len(ids)
        pm2.log_delete_vectors("db", "c", [ids[0]])  # and stays appendable
        pm2.stop()
        engine3, pm3 = make_manager(tmp_path)
        r3 = pm3.recover()
        assert r3["aof_commands"] == 4 and not r3["degraded"]
        pm3.stop()

    def test_corrupt_aof_tail_strict_raises(self, tmp_path, rng):
        self._write_and_stop(tmp_path, rng)
        aof_path = tmp_path / "data" / "appendonly.aof"
        aof_path.write_bytes(aof_path.read_bytes() + b"\x01")
        engine2, pm2 = make_manager(tmp_path, strict_recovery=True)
        with pytest.raises(ScintireteError) as exc:
            pm2.recover()
        assert exc.value.code == ErrorCode.CORRUPTED_DATA
        pm2.stop()

    def test_corrupt_rdb_set_aside(self, tmp_path, rng):
        engine, pm = make_manager(tmp_path)
        populate(engine, rng, n=5)
        pm.save_snapshot()
        pm.log_create_database("after")
        engine.create_database("after")
        pm.stop()
        rdb_path = tmp_path / "data" / "vector.rdb"
        rdb_path.write_bytes(b"garbage-not-an-rdb")

        engine2, pm2 = make_manager(tmp_path)
        result = pm2.recover()
        assert result["rdb_loaded"] is False
        assert result["degraded"][0]["source"] == "rdb"
        assert os.path.exists(result["degraded"][0]["preserved_as"])
        assert not rdb_path.exists()  # moved aside, not deleted
        assert "after" in engine2.list_databases()
        pm2.stop()


class TestReviewHardening:
    def test_metadata_nd_sentinel_key_roundtrips(self, tmp_path):
        engine, pm = make_manager(tmp_path)
        col = engine.create_database("db").create_collection(CFG())
        evil = {"__nd__": True, "note": "user data"}
        ids = col.insert([([1.0] * 8, evil)])
        pm.log_create_database("db")
        pm.log_create_collection("db", "c", {"metric": 1, "hnsw": {}})
        pm.log_insert_vectors("db", "c", [
            {"id": ids[0], "elements": [1.0] * 8, "metadata": evil}
        ])
        pm.stop()
        engine2, pm2 = make_manager(tmp_path)
        info = pm2.recover()
        assert not info["degraded"]
        got = engine2.get_database("db").get_collection("c").get(ids[0])
        assert got.metadata == evil
        pm2.stop()

    def test_structurally_damaged_rdb_sets_aside(self, tmp_path, rng):
        from scintirete_tpu_torch.persistence.rdb import MAGIC

        engine, pm = make_manager(tmp_path)
        populate(engine, rng, n=5)
        pm.save_snapshot()
        pm.stop()
        raw = open(pm.rdb.path, "rb").read()
        state = serde.loads(raw[len(MAGIC):])
        del state["databases"]["db"]["collections"]["c"]["graph"]["count"]
        with open(pm.rdb.path, "wb") as fh:
            fh.write(MAGIC)
            fh.write(serde.dumps(state))

        engine2, pm2 = make_manager(tmp_path)
        info = pm2.recover()
        assert any(d["source"] == "rdb" for d in info["degraded"])
        assert not info["rdb_loaded"]
        pm2.stop()

    def test_out_of_order_aof_degrades_not_aborts(self, tmp_path, rng):
        engine, pm = make_manager(tmp_path)
        populate(engine, rng, n=3)
        pm.log_create_database("db")
        pm.log_drop_collection("db", "c")  # the drop won the AOF gate
        pm.log_insert_vectors("db", "c", [
            {"id": 99, "elements": [0.0] * 8, "metadata": None}
        ])
        pm.stop()
        engine2, pm2 = make_manager(tmp_path)
        info = pm2.recover()
        assert any(d["source"] == "aof_apply" for d in info["degraded"])
        assert "db" in engine2.list_databases()
        pm2.stop()
        engine3, pm3 = make_manager(tmp_path, strict_recovery=True)
        with pytest.raises(ScintireteError):
            pm3.recover()
        pm3.stop()

    @pytest.mark.parametrize("index_type", ["hnsw", "flat"])
    def test_rewrite_preserves_next_id_high_water(self, tmp_path, rng,
                                                  index_type):
        engine, pm = make_manager(tmp_path, aof_rewrite_size_bytes=1)
        col = engine.create_database("db").create_collection(
            dataclasses.replace(CFG(), index_type=index_type)
        )
        data = rng.standard_normal((10, 8)).astype(np.float32)
        ids = col.insert([(v, {"i": i}) for i, v in enumerate(data)])
        log_collection(pm, ids, data)
        col.delete([ids[-1]])  # delete the highest id
        assert pm.maybe_rewrite_aof()
        pm.stop()
        engine2, pm2 = make_manager(tmp_path)
        pm2.recover()
        col2 = engine2.get_database("db").get_collection("c")
        assert col2.config.index_type == index_type
        assert [v.id for v in col2.get_multiple(ids)] == ids[:-1]
        assert col2.insert([([2.0] * 8, None)]) == [max(ids) + 1]
        pm2.stop()


class TestCorruptionFuzz:
    """Flip one random byte of the AOF or the RDB: non-strict recovery
    never raises, and the engine stays usable."""

    @pytest.mark.parametrize("target", ["aof", "rdb"])
    def test_single_byte_flips_never_crash(self, tmp_path, target):
        rng = np.random.default_rng(1234)
        base_dir = tmp_path / "seedstate"
        base_dir.mkdir()
        engine, pm = make_manager(base_dir)
        col, data, ids = populate(engine, rng, n=12)
        log_collection(pm, ids, data)
        if target == "rdb":
            pm.save_snapshot()
            pm.log_delete_vectors("db", "c", [ids[0]])
        pm.stop()
        fname = "appendonly.aof" if target == "aof" else "vector.rdb"
        good = (base_dir / "data" / fname).read_bytes()
        for trial, pos in enumerate(
            np.random.default_rng(99).integers(0, len(good), 10)
        ):
            tdir = tmp_path / f"t{trial}"
            shutil.copytree(base_dir, tdir)
            buf = bytearray(good)
            buf[pos] ^= 0xFF
            (tdir / "data" / fname).write_bytes(bytes(buf))
            engine2, pm2 = make_manager(tdir)
            try:
                result = pm2.recover()  # must NOT raise in non-strict mode
                pm2.log_create_database("fuzzcheck")
                engine2.create_database("fuzzcheck")
                assert isinstance(result.get("degraded"), list)
            finally:
                pm2.stop()


class TestAdminCLI:
    def test_backup_create_list_restore_inspect(self, tmp_path, rng, capsys):
        from scintirete_tpu_torch.cli.admin_main import main as admin

        engine, pm = make_manager(tmp_path)
        populate(engine, rng, n=5)
        pm.save_snapshot()
        pm.stop()
        data_dir = str(tmp_path / "data")

        assert admin(["-data-dir", data_dir, "backup", "create"]) == 0
        backup_path = capsys.readouterr().out.strip()
        assert os.path.exists(backup_path)
        assert admin(["-data-dir", data_dir, "backup", "list"]) == 0
        assert backup_path in capsys.readouterr().out

        (tmp_path / "data" / "vector.rdb").write_bytes(b"junk")
        assert admin(
            ["-data-dir", data_dir, "backup", "restore", backup_path]
        ) == 0
        capsys.readouterr()
        engine2, pm2 = make_manager(tmp_path)
        result = pm2.recover()
        assert result["rdb_loaded"] is True
        assert engine2.get_database("db").get_collection("c").count() == 5
        pm2.stop()

        assert admin(["-data-dir", data_dir, "inspect"]) == 0
        info = json.loads(capsys.readouterr().out)
        assert info["rdb"]["exists"] and info["backups"]
        # a missing backup is an error exit
        assert admin(["-data-dir", data_dir, "backup", "restore",
                      str(tmp_path / "nope")]) == 1

    def test_memstat_as_jax_tool(self, tmp_path, rng, capsys):
        from scintirete_tpu.cli.admin_main import main as jadmin
        from scintirete_tpu_torch.cli.admin_main import main as admin

        engine, pm = make_manager(tmp_path)
        populate(engine, rng, n=7)
        pm.save_snapshot()
        pm.stop()
        data_dir = str(tmp_path / "data")

        assert admin(["-data-dir", data_dir, "memstat"]) == 0
        rep = json.loads(capsys.readouterr().out)
        assert jadmin(["-data-dir", data_dir, "memstat"]) == 0
        assert rep == json.loads(capsys.readouterr().out)
        col = rep["databases"]["db"]["c"]
        assert col["count"] == 7 and col["live"] == 7
        assert col["snapshot_arrays"]["vectors"] == 7 * col["dim"] * 4
        assert admin(["-data-dir", str(tmp_path), "memstat"]) == 1

    def test_memstat_aggregates_sharded_graphs(self):
        from scintirete_tpu.cli.admin_main import _memstat as jmemstat
        from scintirete_tpu_torch.cli.admin_main import _memstat

        sub = {
            "kind": "hnsw", "count": 1000, "live": 990, "dim": 16,
            "vectors": np.zeros((1000, 16), np.float32),
            "levels": np.zeros(1000, np.int8),
            "deleted": np.zeros(1000, bool),
            "neighbors0": np.zeros((1000, 16), np.int32),
            "params": {"m": 8},
        }
        state = {"version": "1.0", "databases": {"db": {"collections": {
            "c": {"graph": {"sharded": True, "dim": 16, "metric": 1,
                            "shards": [dict(sub), dict(sub)]},
                  "metadata": {}},
        }}}}
        rep = _memstat(state)
        assert rep == jmemstat(state)
        col = rep["databases"]["db"]["c"]
        assert col["count"] == 2000 and col["live"] == 1980
        assert col["shards"] == 2
