"""The port imports no JAX and nothing of the JAX package, and never falls
back from CUDA to the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

_SCRIPT = r"""
import sys
import numpy as np
from scintirete_tpu_torch import DistanceMetric, HNSWParams, SearchParams
from scintirete_tpu_torch.engine import Engine
from scintirete_tpu_torch.index.hnsw import HNSWIndex
from scintirete_tpu_torch.types import CollectionConfig

rng = np.random.default_rng(0)
base = rng.standard_normal((4300, 8)).astype(np.float32)
params = HNSWParams(m=4, ef_construction=16, seed=1)
idx = HNSWIndex(8, params, DistanceMetric.COSINE, device="cpu")
idx.bulk_insert(list(range(1, 2101)), base[:2100])  # the kNN bulk build
idx.bulk_insert(list(range(2101, 4301)), base[2100:])  # the batched append
hits = idx.search(base[7], SearchParams(top_k=3))
assert hits[0][0] == 8, hits
assert idx.search(base[4000], SearchParams(top_k=1))[0][0] == 4001
# the descent entries: mid-layer greedy and beam, and the pure walk
import scintirete_tpu_torch.index.device as device_mod
idx.entry_mode, device_mod.MID_CAP = "descent", 64
for idx.descent_mid, idx.ef_upper in ((True, 1), (True, 4), (False, 1)):
    assert idx.search(base[7], SearchParams(top_k=3))[0][0] == 8
assert idx._get_device().graph.mid_level >= 1
# the seq upper-layer build and a refined layer 0
seq = HNSWIndex(8, params, DistanceMetric.COSINE, device="cpu",
                upper_mode="seq")
seq.bulk_insert(list(range(1, 2101)), base[:2100])
assert seq.build_stats["upper_rounds"] >= 1
assert seq.search(base[7], SearchParams(top_k=3))[0][0] == 8
refined = HNSWIndex(8, HNSWParams(m=4, ef_construction=16, seed=1,
                                  refine_rounds=1),
                    DistanceMetric.COSINE, device="cpu")
refined.bulk_insert(list(range(1, 2101)), base[:2100])
assert refined.build_stats["refine_s"] > 0
assert refined.search(base[7], SearchParams(top_k=3))[0][0] == 8
# the chunked device insertion, through the engine
col = Engine(device="cpu").create_database("d").create_collection(
    CollectionConfig(name="c", hnsw=params)
)
col.insert([(v, None) for v in base[:300]])
assert col.search(base[290], SearchParams(top_k=1))[0].id == 291
# sharding: a two-shard HNSW index, a sharded flat index and a
# shard_devices = 2 engine
from scintirete_tpu_torch.config import TPUConfig
from scintirete_tpu_torch.parallel import (
    ShardedFlatIndex, ShardedHNSWIndex, make_default_mesh,
)
two = make_default_mesh(2, "cpu")
sharded = ShardedHNSWIndex(8, params, DistanceMetric.COSINE, devices=two)
sharded.bulk_insert(list(range(1, 201)), base[:200])
assert sharded.search_batch(base[7:8], SearchParams(top_k=3))[0][0][0] == 8
sflat = ShardedFlatIndex(8, DistanceMetric.L2, devices=two)
sflat.build(list(range(1, 201)), base[:200])
assert sflat.search(base[7:8], k=1)[0][0][0] == 8
col = Engine(device="cpu", tpu_config=TPUConfig(shard_devices=2)) \
    .create_database("d").create_collection(CollectionConfig(name="c", hnsw=params))
col.insert([(v, None) for v in base[:100]])
assert isinstance(col._index, ShardedHNSWIndex)
assert col.search(base[50], SearchParams(top_k=1))[0].id == 51
# a flat collection (the two-pass route) and a flat index on the fused route
flat = Engine(device="cpu").create_database("d").create_collection(
    CollectionConfig(name="f", index_type="flat")
)
flat.insert([(v, None) for v in base[:300]])
assert flat.search(base[290], SearchParams(top_k=1))[0].id == 291
assert flat.delete([291]) == 1
assert flat.search(base[290], SearchParams(top_k=1))[0].id != 291
from scintirete_tpu_torch.index.flat import FlatIndex
fused = FlatIndex(8, metric=DistanceMetric.L2, device="cpu", fused_min_cap=1024)
fused.bulk_insert(list(range(1, 2101)), base[:2100])
assert fused.search(base[2000], SearchParams(top_k=1))[0][0] == 2001
assert fused._dev["scan"].dtype.is_floating_point is False
# durability: a snapshot with an AOF tail, a recovery, and an AOF rewrite
# recovered from the log alone
import tempfile
from scintirete_tpu_torch.persistence import PersistenceManager
with tempfile.TemporaryDirectory() as tmp:
    live = Engine(device="cpu")
    pm = PersistenceManager(live, tmp + "/a")
    col = live.create_database("d").create_collection(
        CollectionConfig(name="c", hnsw=params)
    )
    pm.log_create_database("d")
    pm.log_create_collection("d", "c", {"hnsw": {"m": 4, "seed": 1}})
    for rows in (base[:200], base[200:260]):
        ids = col.insert([(v, {"k": 1}) for v in rows])
        pm.log_insert_vectors("d", "c", [
            {"id": i, "elements": v.tolist(), "metadata": {"k": 1}}
            for i, v in zip(ids, rows)
        ])
        if len(rows) == 200:
            pm.save_snapshot()
    pm.stop()
    back = Engine(device="cpu")
    pm = PersistenceManager(back, tmp + "/a")
    report = pm.recover()
    pm.stop()
    assert report["rdb_loaded"] and report["aof_commands"] == 1, report
    assert back.get_database("d").get_collection("c").get(250).metadata == {"k": 1}
    pm = PersistenceManager(flat_engine := Engine(device="cpu"), tmp + "/b",
                            aof_rewrite_size_bytes=1)
    rows = flat_engine.create_database("d").create_collection(
        CollectionConfig(name="f", index_type="flat")
    )
    ids = rows.insert([(v, None) for v in base[:300]])
    pm.log_create_database("d")  # the log to compact
    assert pm.maybe_rewrite_aof()
    pm.stop()
    pm = PersistenceManager(again := Engine(device="cpu"), tmp + "/b")
    assert pm.recover()["aof_commands"] == 5
    pm.stop()
    assert again.get_database("d").get_collection("f").count() == 300
    # the server: the service on the CPU, one RPC over gRPC and one over HTTP
    import json
    import urllib.request
    from scintirete_tpu_torch.config import Config
    from scintirete_tpu_torch.proto import scintirete_pb2 as pb
    from scintirete_tpu_torch.server.grpc_server import GrpcClient, GrpcServer
    from scintirete_tpu_torch.server.http_server import HttpGateway
    from scintirete_tpu_torch.server.service import ScintireteService
    cfg = Config()
    cfg.server.passwords = ["pw"]
    cfg.persistence.data_dir = tmp + "/server"
    svc = ScintireteService(cfg, device="cpu")
    svc.start()
    server, gateway = GrpcServer(svc, port=0), HttpGateway(svc, port=0)
    server.start()
    gateway.start()
    client = GrpcClient(f"127.0.0.1:{server.port}", timeout=10)
    client.CreateDatabase(pb.CreateDatabaseRequest(
        auth=pb.AuthInfo(password="pw"), name="d"))
    req = urllib.request.Request(
        f"http://127.0.0.1:{gateway.port}/api/v1/databases",
        headers={"Authorization": "Bearer pw"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert json.loads(resp.read())["names"] == ["d"]
    client.close()
    gateway.stop()
    server.stop()
    svc.stop()
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or m == "scintirete_tpu" or m.startswith("scintirete_tpu.")
    or m.split(".")[0] == "flatbuffers"
)
assert not leaked, leaked
print("ok")
"""


def test_port_builds_and_searches_without_jax():
    """A build, an append, the descent and mid-layer searches, a seq
    upper-layer build, a refined build, a chunked insert, a sharded HNSW
    index, a sharded flat index and a `shard_devices = 2` engine, a flat
    insert, delete and search on both flat routes, a snapshot, a recovery, an AOF rewrite and
    the server's service answering one request over gRPC and one over HTTP
    leave neither jax, any module of the JAX package nor flatbuffers in
    sys.modules."""
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
        timeout=120, cwd=Path(__file__).resolve().parents[1],
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_cuda_device_without_cuda_raises(monkeypatch):
    from scintirete_tpu_torch.engine import Engine
    from scintirete_tpu_torch.index.hnsw import HNSWIndex
    from scintirete_tpu.types import CollectionConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HNSWIndex(8, device="cuda")
    col = Engine().create_database("d").create_collection(
        CollectionConfig(name="c")
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        col.insert([([0.0] * 8, None)])
    assert col.count() == 0
    flat = Engine().create_database("f").create_collection(
        CollectionConfig(name="c", index_type="flat")
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flat.insert([([0.0] * 8, None)])
    assert flat.count() == 0
