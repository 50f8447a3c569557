"""The port's FlatBuffers interop with the Go reference's files
(`scintirete_tpu_torch.persistence.fbcompat`) and its admin tool against
the JAX package's, on the CPU.

The checked-in fixtures of `tests/golden/` decode the same in both
packages; the port's writers give the JAX package's bytes and parse to
the same records; the RDB export writes a parseable `entrypoint_id` for
HNSW, flat and empty collections; a reference deployment imports into
the port as into the JAX package; the port's admin tool migrates both
ways.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from scintirete_tpu import engine as jengine
from scintirete_tpu import persistence as jpersistence
from scintirete_tpu import types as jtypes
from scintirete_tpu.persistence import fbcompat as jfb
from scintirete_tpu_torch import engine as tengine
from scintirete_tpu_torch import types as ttypes
from scintirete_tpu_torch.engine.database import make_command
from scintirete_tpu_torch.persistence import PersistenceManager
from scintirete_tpu_torch.persistence import fbcompat

GOLDEN = Path(__file__).parent / "golden"


def same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _strip_clock(snap):
    """A read_rdb dict without the writer's clock readings."""
    if isinstance(snap, dict):
        return {k: _strip_clock(v) for k, v in snap.items()
                if k not in ("timestamp", "created_at", "updated_at")}
    return snap


@pytest.mark.parametrize("name", ["aof_create_db.bin", "aof_insert.bin"])
def test_golden_aof_decodes_as_jax(name):
    buf = (GOLDEN / name).read_bytes()
    got = fbcompat.parse_aof_command(buf)
    assert same(got, jfb.parse_aof_command(buf))
    assert got["command_type"] in ("CREATE_DATABASE", "INSERT_VECTORS")


def test_golden_rdb_decodes_as_jax():
    path = str(GOLDEN / "rdb_snapshot.bin")
    got = fbcompat.read_rdb(path)
    assert same(got, jfb.read_rdb(path))
    col = got["databases"]["db"]["collections"]["c"]
    assert col["entrypoint_id"] == "7" and len(col["vectors"]) == 2


def _sample_commands(mk):
    vecs = np.random.default_rng(7).standard_normal((12, 16)).astype(np.float32)
    return [
        mk("CREATE_DATABASE", "mydb", args={"name": "mydb"}, timestamp=100.0),
        mk("CREATE_COLLECTION", "mydb", "vecs", {
            "name": "vecs",
            "config": {"metric": 1, "hnsw": {
                "m": 8, "ef_construction": 40, "ef_search": 30,
                "max_layers": 12, "seed": 9}},
        }, timestamp=101.0),
        mk("INSERT_VECTORS", "mydb", "vecs", {"vectors": [
            {"id": i + 1, "elements": vecs[i],
             "metadata": {"tag": f"v{i}"} if i % 2 == 0 else None}
            for i in range(len(vecs))
        ]}, timestamp=102.0),
        mk("DELETE_VECTORS", "mydb", "vecs", {"ids": ["3", "4"]},
           timestamp=103.0),
        mk("DROP_COLLECTION", "mydb", "vecs", timestamp=104.0),
        mk("DROP_DATABASE", "mydb", timestamp=105.0),
    ], vecs


def test_aof_writer_is_the_jax_writer(tmp_path):
    cmds, _ = _sample_commands(make_command)
    jcmds, _ = _sample_commands(jengine.database.make_command)
    for c, jc in zip(cmds, jcmds):
        buf = fbcompat.write_aof_command(c)
        assert buf == jfb.write_aof_command(jc)
        assert same(fbcompat.parse_aof_command(buf),
                    jfb.parse_aof_command(buf))
    path, jpath = str(tmp_path / "t.aof"), str(tmp_path / "j.aof")
    assert fbcompat.write_aof(cmds, path) == jfb.write_aof(jcmds, jpath) == 6
    assert open(path, "rb").read() == open(jpath, "rb").read()
    assert same(list(fbcompat.iter_aof(path)), list(jfb.iter_aof(jpath)))
    open(path, "wb").write(open(jpath, "rb").read()[:-5])
    with pytest.raises(ValueError, match="truncated"):
        list(fbcompat.iter_aof(path))


def _engines(index_type, n=40, dim=12):
    """The same collections in both packages, on their host paths."""
    out = []
    data = np.random.default_rng(11).standard_normal((n, dim)).astype(np.float32)
    for eng, t in ((jengine.Engine(use_device=False), jtypes),
                   (tengine.Engine(use_device=False, device="cpu"), ttypes)):
        db = eng.create_database("refdb")
        col = db.create_collection(t.CollectionConfig(
            name="c1", metric=t.DistanceMetric.COSINE, index_type=index_type,
            hnsw=t.HNSWParams(m=8, ef_construction=40, ef_search=30, seed=3),
        ))
        ids = col.insert([(v, {"i": i}) for i, v in enumerate(data)])
        col.delete(ids[:3])
        db.create_collection(t.CollectionConfig(name="empty"))
        out.append(eng)
    return out, data, ids


@pytest.mark.parametrize("index_type", ["hnsw", "flat"])
def test_rdb_export_parses_as_jax(tmp_path, index_type):
    (jeng, teng), data, ids = _engines(index_type)
    jpath, tpath = str(tmp_path / "j.rdb"), str(tmp_path / "t.rdb")
    want = jfb.export_rdb(jeng, jpath)
    assert fbcompat.export_rdb(teng, tpath) == want
    got = fbcompat.read_rdb(tpath)
    assert same(_strip_clock(got), _strip_clock(jfb.read_rdb(jpath)))
    assert same(got, jfb.read_rdb(tpath))
    col = got["databases"]["refdb"]["collections"]["c1"]
    assert col["vector_count"] == 37 and col["deleted_count"] == 3
    by_id = {v["id"]: v for v in col["vectors"]}
    np.testing.assert_array_equal(by_id[ids[5]]["elements"], data[5])
    assert by_id[ids[5]]["metadata"] == {"i": 5}


def test_rdb_export_entrypoint_always_parses(tmp_path):
    """The reference ParseUint's entrypoint_id (rdb.go:1080) and fails the
    whole file on an empty one: HNSW collections name their entry node,
    flat ones their first live id, empty ones "0"."""
    eng = tengine.Engine(use_device=False, device="cpu")
    db = eng.create_database("d")
    hcol = db.create_collection(ttypes.CollectionConfig(
        name="h", metric=ttypes.DistanceMetric.L2,
        hnsw=ttypes.HNSWParams(m=8, ef_construction=40, seed=3),
    ))
    hids = hcol.insert([(np.arange(4, dtype=np.float32) + i, {"i": i})
                        for i in range(5)])
    fcol = db.create_collection(ttypes.CollectionConfig(
        name="f", metric=ttypes.DistanceMetric.COSINE, index_type="flat",
    ))
    fids = fcol.insert([(np.ones(4, np.float32) * (i + 1), None)
                        for i in range(3)])
    fcol.delete(fids[:1])
    db.create_collection(ttypes.CollectionConfig(name="e", index_type="flat"))
    db.create_collection(ttypes.CollectionConfig(name="e2"))

    path = str(tmp_path / "out.rdb")
    fbcompat.export_rdb(eng, path)
    buf = open(path, "rb").read()
    dbt = fbcompat._Tbl(fbcompat._root(buf)).vec_table(2, 0)
    cols = {dbt.vec_table(1, j).string(0): dbt.vec_table(1, j)
            for j in range(dbt.vec_len(1))}
    assert set(cols) == {"h", "f", "e", "e2"}
    entry = {name: int(c.table(3).string(1)) for name, c in cols.items()}
    assert entry["h"] in set(hids)
    assert entry["f"] == fids[1]  # first LIVE id (fids[0] deleted)
    assert entry["e"] == entry["e2"] == 0
    assert cols["f"].i64(4) == 2 and cols["f"].i64(5) == 1
    node0 = cols["h"].table(3).vec_table(0, 0)
    assert node0.vec_len(4) >= 1 and node0.vec_table(4, 0).vec_len(1) >= 1


@pytest.mark.parametrize("index_type", ["hnsw", "flat"])
def test_import_reference_as_jax(tmp_path, index_type):
    (jeng, _), data, ids = _engines("hnsw")
    rdb_path, aof_path = str(tmp_path / "ref.rdb"), str(tmp_path / "ref.aof")
    jfb.export_rdb(jeng, rdb_path)
    jfb.write_aof([
        jengine.database.make_command("INSERT_VECTORS", "refdb", "c1", {
            "vectors": [
                {"id": ids[5], "elements": data[5], "metadata": None},
                {"id": 10_000, "elements": data[0] * 2, "metadata": {"x": 1}},
            ]}),
        jengine.database.make_command("DELETE_VECTORS", "refdb", "c1",
                                      {"ids": [str(ids[6])]}),
    ], aof_path)
    engines = (jengine.Engine(use_device=False),
               tengine.Engine(use_device=False, device="cpu"))
    stats = [fb.import_reference(e, rdb_path=rdb_path, aof_path=aof_path,
                                 index_type=index_type)
             for fb, e in zip((jfb, fbcompat), engines)]
    assert stats[0] == stats[1]
    assert stats[1]["vectors"] == 37 and stats[1]["aof_commands"] == 2
    jcol, tcol = (e.get_database("refdb").get_collection("c1")
                  for e in engines)
    assert tcol.config.index_type == index_type and tcol.count() == 37
    every = list(ids) + [10_000]
    assert ([(v.id, v.elements, v.metadata) for v in tcol.get_multiple(every)]
            == [(v.id, v.elements, v.metadata)
                for v in jcol.get_multiple(every)])
    assert tcol.get_multiple(ids[:3] + [ids[6]]) == []
    assert tcol.search(data[10], ttypes.SearchParams(top_k=1))[0].id == ids[10]
    assert tcol.insert([(data[0] + 1.0, None)]) == [10_001]


def test_admin_cli_migrates_both_ways(tmp_path, capsys):
    from scintirete_tpu_torch.cli.admin_main import main

    cmds, vecs = _sample_commands(make_command)
    aof_path = str(tmp_path / "appendonly.aof")
    fbcompat.write_aof(cmds[:4], aof_path)
    data_dir = str(tmp_path / "data")
    assert main(["-data-dir", data_dir, "-device", "cpu", "import-reference",
                 "--ref-aof", aof_path]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["imported"]["aof_commands"] == 4
    assert main(["-data-dir", data_dir, "-device", "cpu",
                 "import-reference"]) == 1
    capsys.readouterr()

    # the import landed in the port's persistence format: a restartable
    # engine in either package
    for eng, manager in (
        (tengine.Engine(use_device=False, device="cpu"), PersistenceManager),
        (jengine.Engine(use_device=False), jpersistence.PersistenceManager),
    ):
        pm = manager(eng, data_dir)
        report = pm.recover()
        pm.stop()
        assert report["rdb_loaded"] and report["aof_commands"] == 0
        col = eng.get_database("mydb").get_collection("vecs")
        assert col.count() == 10 and col.config.hnsw.seed == 9

    out_path = str(tmp_path / "back.rdb")
    assert main(["-data-dir", data_dir, "-device", "cpu", "export-reference",
                 out_path]) == 0
    # nodes: the 10 live vectors and the 2 tombstones
    assert json.loads(capsys.readouterr().out)["exported"]["vectors"] == 12
    snap = jfb.read_rdb(out_path)["databases"]["mydb"]["collections"]["vecs"]
    assert snap["vector_count"] == 10 and snap["deleted_count"] == 2
    assert int(snap["entrypoint_id"]) > 0
    by_id = {v["id"]: v for v in snap["vectors"]}
    np.testing.assert_array_equal(by_id[1]["elements"], vecs[0])
    assert by_id[1]["metadata"] == {"tag": "v0"}


def test_admin_cli_rebuilds_on_the_card_by_default(tmp_path, monkeypatch):
    """Without -device the migration's engine is on the card: on a machine
    without CUDA it raises, and never runs on the CPU instead."""
    import torch

    from scintirete_tpu_torch.cli.admin_main import main

    cmds, _ = _sample_commands(make_command)
    aof_path = str(tmp_path / "appendonly.aof")
    fbcompat.write_aof(cmds[:4], aof_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-data-dir", str(tmp_path / "data"), "import-reference",
              "--ref-aof", aof_path])
