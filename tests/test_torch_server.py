"""The port's service (`scintirete_tpu_torch/server/`) against the JAX
package's, and the port's config, observability, batcher, embedding client
and rate limiter on their own (mirrors of `tests/test_api.py`,
`tests/test_batcher.py`, `tests/test_observability.py` and
`tests/test_types_config.py` at small shapes).

Parity: one scripted request sequence, with seeded numpy data, goes through
the JAX package's `ScintireteService` and the port's, each path against
its counterpart: `use_device=False` (the host paths) in both, and the
device path with `device_search_min_size=0`, the port's on `device="cpu"`
(the plain torch versions of the kernels: the pivot scan and the beam)
against the JAX package's on XLA's CPU backend. The device paths of both
packages score L2 in the expanded form (|q|^2 + |b|^2 - 2 q.b), whose
square root departs from the host paths' direct difference by more than
1e-5 near a match, so each path is held to its own. The responses must be
equal, ids exact and floats within 1e-5; errors must carry the same code.
The one exception: L2 distances of the device paths, whose two packages
sum in other orders, are held to the f32 rounding bound of the expanded
form (`L2_SQ_TOL`). HNSW collections are seeded and searched at an ef that
covers the collection, so every side returns the exact top-k.
"""

import dataclasses
import io
import json
import os
import threading
import time

import numpy as np
import pytest
from google.protobuf import json_format

from scintirete_tpu.config import Config as JaxConfig
from scintirete_tpu.config import EmbeddingModel as JaxModel
from scintirete_tpu.config import load_config as jax_load_config
from scintirete_tpu.errors import ScintireteError as JaxError
from scintirete_tpu.server.service import ScintireteService as JaxService
from scintirete_tpu_torch import CollectionConfig
from scintirete_tpu_torch.config import Config, EmbeddingConfig, EmbeddingModel
from scintirete_tpu_torch.config import load_config
from scintirete_tpu_torch.embedding import EmbeddingClient
from scintirete_tpu_torch.errors import ErrorCode, ScintireteError
from scintirete_tpu_torch.observability.audit import AuditLogger, hash_user_id
from scintirete_tpu_torch.observability.logger import StructuredLogger
from scintirete_tpu_torch.observability.metrics import MetricsRegistry
from scintirete_tpu_torch.observability.monitor import (
    SystemMonitor,
    sample_device_stats,
)
from scintirete_tpu_torch.proto import scintirete_pb2 as pb
from scintirete_tpu_torch.server.batcher import SearchBatcher
from scintirete_tpu_torch.server.ratelimit import TokenBucketLimiter
from scintirete_tpu_torch.server.service import (
    RPC_METHODS,
    ScintireteService,
    dict_to_struct,
)
from tests.test_api import FakeEmbeddingServer

PASSWORD = "test-password"
TEMPLATE = os.path.join(
    os.path.dirname(__file__), "..", "configs", "scintirete-tpu.template.toml"
)
DIM, N_HNSW, N_FLAT = 8, 160, 96
FLOAT_TOL = 1e-5
DISTANCE_KEYS = ("distance", "distances_packed")
# each of the port's services and the JAX service it is held against
PAIRS = {"host": "jax", "cpu": "jax_device"}


def auth(password=PASSWORD):
    return pb.AuthInfo(password=password)


def fill_config(cfg, data_dir, embed_url, model_cls):
    cfg.server.passwords = [PASSWORD]
    cfg.persistence.data_dir = str(data_dir)
    cfg.embedding.base_url = embed_url
    cfg.embedding.api_key = "test-key"
    cfg.embedding.default_model = "fake-model"
    cfg.embedding.models = [
        model_cls(id="fake-model", name="Fake", dimension=8, available=True)
    ]
    return cfg


def make_service(side, data_dir, embed_url="http://127.0.0.1:1/v1/embeddings"):
    """A started service of one side: "jax" / "jax_device" (the reference
    on its host paths / its device path), "host" (the port on its host
    paths) or "cpu" (the port's device path on the CPU)."""
    if side.startswith("jax"):
        cfg = fill_config(JaxConfig(), data_dir, embed_url, JaxModel)
        cfg.tpu.device_search_min_size = 0
        svc = JaxService(cfg, use_device=side == "jax_device")
    elif side == "host":
        cfg = fill_config(Config(), data_dir, embed_url, EmbeddingModel)
        svc = ScintireteService(cfg, use_device=False, device="cpu")
    else:
        cfg = fill_config(Config(), data_dir, embed_url, EmbeddingModel)
        cfg.tpu.device_search_min_size = 0
        svc = ScintireteService(cfg, device="cpu")
    svc.start()
    return svc


def data():
    rng = np.random.default_rng(0)
    hnsw = rng.standard_normal((N_HNSW, DIM)).astype(np.float32)
    flat = rng.standard_normal((N_FLAT, DIM)).astype(np.float32)
    queries = np.concatenate([
        hnsw[:6] + 0.05 * rng.standard_normal((6, DIM)).astype(np.float32),
        flat[:6] + 0.05 * rng.standard_normal((6, DIM)).astype(np.float32),
    ])
    return hnsw, flat, queries


def insert_request(db, col, rows, with_meta=True):
    req = pb.InsertVectorsRequest(auth=auth(), db_name=db, collection_name=col)
    for i, v in enumerate(rows):
        vec = pb.Vector(elements=v.tolist())
        if with_meta:
            vec.metadata.CopyFrom(dict_to_struct({"row": i, "tag": f"t{i % 3}"}))
        req.vectors.append(vec)
    return req


def batch_request(db, col, queries, top_k, dtype="f32", ef=None):
    packed = queries.astype(np.float16 if dtype == "f16" else np.float32)
    req = pb.BatchSearchRequest(
        auth=auth(), db_name=db, collection_name=col,
        queries_packed=packed.tobytes(), num_queries=len(queries),
        dim=queries.shape[1], top_k=top_k, dtype=dtype,
    )
    if ef is not None:
        req.ef_search = ef
    return req


def seed_collection(svc, db, col, seed):
    """Seed an HNSW collection's level draw (the server's defaults carry
    none), so that both packages build the same kind of graph each run."""
    c = svc.engine.get_database(db).get_collection(col)
    c.config = dataclasses.replace(
        c.config, hnsw=dataclasses.replace(c.config.hnsw, seed=seed))


def script(hnsw, flat, queries):
    """The scripted sequence: (step name, function of the service)."""
    qh, qf = queries[:6], queries[6:]
    ef = N_HNSW  # covers the collection: the exact top-k on every side

    def search(col, q, **kw):
        return lambda s: [
            s.Search(pb.SearchRequest(
                auth=auth(), db_name="db", collection_name=col,
                query_vector=v.tolist(), **kw))
            for v in q
        ]

    def create(name, **kw):
        return lambda s: s.CreateCollection(pb.CreateCollectionRequest(
            auth=auth(), db_name="db", collection_name=name, **kw))

    def create_seeded(name, seed, **kw):
        def step(s):
            out = create(name, **kw)(s)
            seed_collection(s, "db", name, seed)
            return out
        return step

    return [
        ("wrong_password", lambda s: s.ListDatabases(
            pb.ListDatabasesRequest(auth=auth("nope")))),
        ("empty_password", lambda s: s.ListDatabases(pb.ListDatabasesRequest())),
        ("create_db", lambda s: s.CreateDatabase(
            pb.CreateDatabaseRequest(auth=auth(), name="db"))),
        ("create_db_again", lambda s: s.CreateDatabase(
            pb.CreateDatabaseRequest(auth=auth(), name="db"))),
        ("create_db_nameless", lambda s: s.CreateDatabase(
            pb.CreateDatabaseRequest(auth=auth()))),
        ("list_dbs", lambda s: s.ListDatabases(pb.ListDatabasesRequest(auth=auth()))),
        ("create_hnsw", create_seeded(
            "h", 7, metric_type=pb.COSINE,
            hnsw_config=pb.HnswConfig(m=8, ef_construction=64))),
        ("create_hnsw_l2", create_seeded("l2", 9, metric_type=pb.L2)),
        ("create_flat", create("f", metric_type=pb.L2, index_type="flat")),
        ("create_unspecified_metric", create("u")),
        ("create_bad_index_type", create("x", metric_type=pb.L2,
                                         index_type="ivf")),
        ("create_in_missing_db", lambda s: s.CreateCollection(
            pb.CreateCollectionRequest(auth=auth(), db_name="nodb",
                                       collection_name="c",
                                       metric_type=pb.L2))),
        ("create_again", create("f", metric_type=pb.L2)),
        ("insert_hnsw", lambda s: s.InsertVectors(insert_request("db", "h", hnsw))),
        ("insert_hnsw_l2", lambda s: s.InsertVectors(
            insert_request("db", "l2", hnsw[:40], with_meta=False))),
        ("insert_flat", lambda s: s.InsertVectors(insert_request("db", "f", flat))),
        ("insert_empty", lambda s: s.InsertVectors(
            pb.InsertVectorsRequest(auth=auth(), db_name="db", collection_name="f"))),
        ("insert_wrong_dim", lambda s: s.InsertVectors(
            insert_request("db", "f", np.ones((2, DIM + 1), np.float32)))),
        ("search_hnsw", search("h", qh, top_k=5, ef_search=ef)),
        ("search_hnsw_vectors", search("h", qh[:2], top_k=3, ef_search=ef,
                                       include_vector=True)),
        ("search_hnsw_l2", search("l2", qh[:3], top_k=4, ef_search=ef)),
        ("search_flat", search("f", qf, top_k=5)),
        ("search_flat_vectors", search("f", qf[:2], top_k=2, include_vector=True)),
        ("search_top_k_past_count", search("l2", qh[:1], top_k=60, ef_search=ef)),
        ("search_no_query", lambda s: s.Search(pb.SearchRequest(
            auth=auth(), db_name="db", collection_name="f", top_k=5))),
        ("search_top_k_zero", search("f", qf[:1], top_k=0)),
        ("search_missing_collection", search("missing", qf[:1], top_k=5)),
        ("search_missing_db", lambda s: s.Search(pb.SearchRequest(
            auth=auth(), db_name="nodb", collection_name="f",
            query_vector=[1.0] * DIM, top_k=5))),
        ("search_nameless_db", lambda s: s.Search(pb.SearchRequest(
            auth=auth(), collection_name="f", query_vector=[1.0] * DIM,
            top_k=5))),
        ("search_wrong_dim", lambda s: s.Search(pb.SearchRequest(
            auth=auth(), db_name="db", collection_name="h",
            query_vector=[1.0] * (DIM + 2), top_k=5))),
        ("batch_hnsw", lambda s: s.BatchSearch(batch_request("db", "h", qh, 5, ef=ef))),
        ("batch_hnsw_f16", lambda s: s.BatchSearch(
            batch_request("db", "h", qh, 5, "f16", ef=ef))),
        ("batch_flat", lambda s: s.BatchSearch(batch_request("db", "f", qf, 5))),
        ("batch_bad_size", lambda s: s.BatchSearch(pb.BatchSearchRequest(
            auth=auth(), db_name="db", collection_name="f",
            queries_packed=b"\x00" * 10, num_queries=5, dim=DIM, top_k=3))),
        ("batch_bad_dtype", lambda s: s.BatchSearch(
            batch_request("db", "f", qf, 5, dtype="bf16"))),
        ("batch_no_queries", lambda s: s.BatchSearch(pb.BatchSearchRequest(
            auth=auth(), db_name="db", collection_name="f", dim=DIM, top_k=3))),
        ("batch_wrong_dim", lambda s: s.BatchSearch(
            batch_request("db", "f", np.ones((2, DIM + 1), np.float32), 5))),
        ("delete_hnsw", lambda s: s.DeleteVectors(pb.DeleteVectorsRequest(
            auth=auth(), db_name="db", collection_name="h", ids=[1, 2, 3, 999]))),
        ("delete_flat", lambda s: s.DeleteVectors(pb.DeleteVectorsRequest(
            auth=auth(), db_name="db", collection_name="f", ids=[1, 5, 9]))),
        ("delete_none", lambda s: s.DeleteVectors(pb.DeleteVectorsRequest(
            auth=auth(), db_name="db", collection_name="f"))),
        ("search_hnsw_after_delete", search("h", qh, top_k=5, ef_search=ef)),
        ("search_flat_after_delete", search("f", qf, top_k=5)),
        ("batch_flat_after_delete", lambda s: s.BatchSearch(
            batch_request("db", "f", qf, 5))),
        ("info_hnsw", lambda s: s.GetCollectionInfo(pb.GetCollectionInfoRequest(
            auth=auth(), db_name="db", collection_name="h"))),
        ("info_flat", lambda s: s.GetCollectionInfo(pb.GetCollectionInfoRequest(
            auth=auth(), db_name="db", collection_name="f"))),
        ("list_collections", lambda s: s.ListCollections(
            pb.ListCollectionsRequest(auth=auth(), db_name="db"))),
        ("list_collections_nameless", lambda s: s.ListCollections(
            pb.ListCollectionsRequest(auth=auth()))),
        ("embed_text", lambda s: s.EmbedText(
            pb.EmbedTextRequest(auth=auth(), texts=["hello", "world"]))),
        ("embed_text_empty", lambda s: s.EmbedText(pb.EmbedTextRequest(auth=auth()))),
        ("list_models", lambda s: s.ListEmbeddingModels(
            pb.ListEmbeddingModelsRequest(auth=auth()))),
        ("create_text", create("t", metric_type=pb.COSINE, index_type="flat")),
        ("embed_and_insert", lambda s: s.EmbedAndInsert(pb.EmbedAndInsertRequest(
            auth=auth(), db_name="db", collection_name="t",
            texts=[pb.TextWithMetadata(text=t, metadata=dict_to_struct({"text": t}))
                   for t in ("alpha", "beta", "gamma")]))),
        ("embed_and_search", lambda s: s.EmbedAndSearch(pb.EmbedAndSearchRequest(
            auth=auth(), db_name="db", collection_name="t", query_text="beta",
            top_k=2))),
        ("embed_and_search_no_text", lambda s: s.EmbedAndSearch(
            pb.EmbedAndSearchRequest(auth=auth(), db_name="db",
                                     collection_name="t", top_k=2))),
        ("save", lambda s: s.Save(pb.SaveRequest(auth=auth()))),
        ("drop_collection", lambda s: s.DropCollection(pb.DropCollectionRequest(
            auth=auth(), db_name="db", collection_name="t"))),
        ("drop_collection_missing", lambda s: s.DropCollection(
            pb.DropCollectionRequest(auth=auth(), db_name="db",
                                     collection_name="t"))),
        ("create_db2", lambda s: s.CreateDatabase(
            pb.CreateDatabaseRequest(auth=auth(), name="db2"))),
        ("drop_db2", lambda s: s.DropDatabase(
            pb.DropDatabaseRequest(auth=auth(), name="db2"))),
        ("drop_db_missing", lambda s: s.DropDatabase(
            pb.DropDatabaseRequest(auth=auth(), name="db2"))),
    ]


STEPS = [name for name, _ in script(*data())]
# steps that return L2 distances (the collections "l2" and "f")
L2_STEPS = {name for name in STEPS if "l2" in name or "flat" in name
            or name == "search_top_k_past_count"}


def l2_sq_tol():
    """Twice the f32 rounding bound of one expanded-form squared L2
    distance: each of |q|^2, |b|^2 and q.b is a sum of DIM products, so the
    result is off by at most (DIM + 2) eps times the sum of the terms'
    magnitudes, itself at most 2 (|q|^2 + |b|^2)."""
    hnsw, flat, queries = data()
    rows = max(float((x * x).sum(1).max()) for x in (hnsw, flat))
    qmax = float((queries * queries).sum(1).max())
    return 2 * (DIM + 2) * float(np.finfo(np.float32).eps) * 2 * (rows + qmax)


L2_SQ_TOL = l2_sq_tol()


def record(fn, svc):
    """A response as a plain dict (packed blobs decoded), or the error
    code it raised."""
    try:
        resp = fn(svc)
    except (ScintireteError, JaxError) as exc:
        return {"error": int(exc.code)}
    resps = resp if isinstance(resp, list) else [resp]
    out = []
    for r in resps:
        d = json_format.MessageToDict(r, preserving_proto_field_name=True)
        if isinstance(r, pb.BatchSearchResponse):
            d["ids_packed"] = np.frombuffer(r.ids_packed, np.uint64).tolist()
            d["distances_packed"] = np.frombuffer(
                r.distances_packed, np.float32).tolist()
        if isinstance(r, pb.SaveResponse):
            d.pop("duration_seconds", None)
        out.append(d)
    return out


def assert_same(got, want, where="", sq_tol=0.0):
    """Equal structure and values; floats within FLOAT_TOL, distances
    (where `sq_tol` is given) also within sq_tol on their squares."""
    if isinstance(want, float) or isinstance(got, float):
        g, w = float(got), float(want)
        tol = FLOAT_TOL
        if sq_tol and where.rsplit(".", 1)[-1].split("[")[0] in DISTANCE_KEYS:
            tol = max(tol, sq_tol / max(g + w, 1e-30))
        assert abs(g - w) <= tol, (where, got, want, tol)
    elif isinstance(want, dict):
        assert isinstance(got, dict), (where, got, want)
        # proto3 JSON leaves out a float field at its default: a distance
        # of exactly 0.0 (an exact match) is absent from that side's dict
        for key in DISTANCE_KEYS:
            if (key in got) != (key in want):
                got, want = {key: 0.0, **got}, {key: 0.0, **want}
        assert got.keys() == want.keys(), (where, got, want)
        for key in want:
            assert_same(got[key], want[key], f"{where}.{key}", sq_tol)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (
            where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]", sq_tol)
    else:
        assert got == want, (where, got, want)


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    """Each side's record of every step, and its data directory."""
    hnsw, flat, queries = data()
    fake = FakeEmbeddingServer()
    out = {}
    try:
        for side in list(PAIRS) + list(PAIRS.values()):
            data_dir = tmp_path_factory.mktemp(side) / "data"
            svc = make_service(side, data_dir, fake.url)
            try:
                steps = {name: record(fn, svc)
                         for name, fn in script(hnsw, flat, queries)}
            finally:
                svc.stop()
            out[side] = (steps, data_dir)
    finally:
        fake.stop()
    return out


@pytest.mark.parametrize("side", list(PAIRS))
@pytest.mark.parametrize("step", STEPS)
def test_responses_match_the_jax_service(transcripts, side, step):
    """Every scripted request gets the JAX service's response on the same
    path, or its error code."""
    sq_tol = L2_SQ_TOL if side == "cpu" and step in L2_STEPS else 0.0
    assert_same(transcripts[side][0][step], transcripts[PAIRS[side]][0][step],
                step, sq_tol)


def test_script_reaches_every_rpc(transcripts):
    """The script calls all 16 RPCs and BatchSearch; its searches found
    their own rows and its errors are the expected ones."""
    steps = transcripts["jax"][0]
    called = {
        "CreateDatabase", "DropDatabase", "ListDatabases", "CreateCollection",
        "DropCollection", "GetCollectionInfo", "ListCollections",
        "InsertVectors", "DeleteVectors", "Search", "EmbedAndInsert",
        "EmbedAndSearch", "EmbedText", "ListEmbeddingModels", "Save",
        "BatchSearch",
    }
    assert called | {"BgSave"} == set(RPC_METHODS)
    assert [r["results"][0]["id"] for r in steps["search_hnsw"]] == [
        str(i) for i in range(1, 7)]
    assert steps["search_flat"][0]["results"][0]["id"] == "1"
    assert steps["batch_flat"][0]["ids_packed"][::5] == [1, 2, 3, 4, 5, 6]
    assert steps["wrong_password"] == {"error": int(ErrorCode.UNAUTHORIZED)}
    assert steps["search_missing_collection"] == {
        "error": int(ErrorCode.COLLECTION_NOT_FOUND)}
    assert steps["search_wrong_dim"] == {
        "error": int(ErrorCode.DIMENSION_MISMATCH)}
    assert steps["batch_bad_size"] == {
        "error": int(ErrorCode.INVALID_PARAMETER)}


def recover_and_search(side, data_dir):
    hnsw, flat, queries = data()
    svc = make_service(side, data_dir)
    try:
        return [
            record(lambda s: s.BatchSearch(
                batch_request("db", "h", queries[:6], 5, ef=N_HNSW)), svc),
            record(lambda s: s.BatchSearch(
                batch_request("db", "f", queries[6:], 5)), svc),
            record(lambda s: s.ListCollections(
                pb.ListCollectionsRequest(auth=auth(), db_name="db")), svc),
        ]
    finally:
        svc.stop()


@pytest.mark.parametrize("writer,reader", [
    (ours, theirs) for ours, theirs in PAIRS.items()
] + [(theirs, ours) for ours, theirs in PAIRS.items()])
def test_data_directory_recovers_in_the_other_package(
        transcripts, tmp_path, writer, reader):
    """A data directory one package's service wrote (a snapshot, then an
    AOF tail of drops) recovers in the other's, and searches as the
    writer's own recovery does."""
    import shutil

    src = transcripts[writer][1]
    a, b = tmp_path / "a", tmp_path / "b"
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    sq_tol = L2_SQ_TOL if "cpu" in (writer, reader) else 0.0
    assert_same(recover_and_search(reader, b), recover_and_search(writer, a),
                "", sq_tol)


# ----- the port alone: mirrors of tests/test_api.py -----


@pytest.fixture
def fake_embed():
    server = FakeEmbeddingServer()
    yield server
    server.stop()


@pytest.fixture(params=["host", "cpu"])
def service(request, tmp_path, fake_embed):
    svc = make_service(request.param, tmp_path / "data", fake_embed.url)
    yield svc
    svc.stop()


def setup_collection(svc, metric=pb.L2, index_type=""):
    svc.CreateDatabase(pb.CreateDatabaseRequest(auth=auth(), name="db"))
    svc.CreateCollection(pb.CreateCollectionRequest(
        auth=auth(), db_name="db", collection_name="c", metric_type=metric,
        index_type=index_type))


class TestService:
    def test_insert_search_delete_flow(self, service):
        setup_collection(service)
        vecs = np.random.default_rng(0).standard_normal((10, 8)).astype(np.float32)
        resp = service.InsertVectors(insert_request("db", "c", vecs))
        assert list(resp.inserted_ids) == list(range(1, 11))
        found = service.Search(pb.SearchRequest(
            auth=auth(), db_name="db", collection_name="c",
            query_vector=vecs[3].tolist(), top_k=3))
        assert found.results[0].id == 4
        assert not found.results[0].HasField("vector")
        assert found.results[0].metadata.fields["row"].number_value == 3
        assert service.DeleteVectors(pb.DeleteVectorsRequest(
            auth=auth(), db_name="db", collection_name="c", ids=[4, 999]
        )).deleted_count == 1
        again = service.Search(pb.SearchRequest(
            auth=auth(), db_name="db", collection_name="c",
            query_vector=vecs[3].tolist(), top_k=3))
        assert all(r.id != 4 for r in again.results)

    def test_custom_hnsw_keeps_server_defaults(self, tmp_path):
        """hnsw_config keeps the server-default fields the proto does not
        expose, and the AOF CREATE record carries them to the replay."""
        cfg = Config()
        cfg.server.passwords = [PASSWORD]
        cfg.persistence.data_dir = str(tmp_path / "data")
        cfg.algorithm.hnsw_defaults.neighbor_heuristic = True
        for _ in range(2):  # create, then recover from the AOF
            svc = ScintireteService(cfg, use_device=False, device="cpu")
            svc.start()
            try:
                if not svc.engine.has_database("db"):
                    svc.CreateDatabase(pb.CreateDatabaseRequest(auth=auth(), name="db"))
                    svc.CreateCollection(pb.CreateCollectionRequest(
                        auth=auth(), db_name="db", collection_name="c",
                        metric_type=pb.COSINE,
                        hnsw_config=pb.HnswConfig(m=24, ef_construction=111)))
                col = svc.engine.get_database("db").get_collection("c")
                assert col.config.hnsw.neighbor_heuristic is True
                assert col.config.hnsw.m == 24
            finally:
                svc.stop()

    def test_search_prewarm_on_restart(self, tmp_path):
        """A restarted service searches every restored collection once in
        the background (the mirror upload leaves the first query)."""
        cfg = Config()
        cfg.server.passwords = [PASSWORD]
        cfg.persistence.data_dir = str(tmp_path / "data")
        cfg.tpu.search_batch_size = 32
        svc = ScintireteService(cfg, device="cpu")
        svc.start()
        try:
            setup_collection(svc, pb.COSINE, "flat")
            svc.InsertVectors(insert_request(
                "db", "c", np.ones((50, 8), np.float32), with_meta=False))
            svc.Save(pb.SaveRequest(auth=auth()))
        finally:
            svc.stop()
        svc2 = ScintireteService(cfg, device="cpu")
        svc2.start()
        try:
            svc2._warm_thread.join(timeout=60)
            assert not svc2._warm_thread.is_alive()
            assert svc2._warm_error is None
            assert svc2._warm_info["collections"] == 1
            assert svc2._warm_info["width"] == 32
        finally:
            svc2.stop()

    def test_no_prewarm_on_host_paths(self, service):
        assert (service._warm_thread is None) == (not service._use_device)

    def test_prewarm_failure_only_warns(self, tmp_path):
        cfg = Config()
        cfg.persistence.data_dir = str(tmp_path / "data")
        buf = io.StringIO()
        svc = ScintireteService(
            cfg, device="cpu",
            logger=StructuredLogger(level="warn", fmt="json", stream=buf))
        svc.start()
        try:
            svc.engine.create_database("d").create_collection(
                CollectionConfig(name="c", index_type="flat")
            ).insert([([1.0] * 4, None)])

            def broken(*a, **k):
                raise RuntimeError("no mirror")

            col = svc.engine.get_database("d").get_collection("c")
            col.search_batch_arrays = broken
            svc._warm_search()
            assert svc._warm_error == "RuntimeError('no mirror')"
            assert "search prewarm failed" in buf.getvalue()
        finally:
            svc.stop()

    def test_save_recover_and_aof_replay(self, service):
        setup_collection(service)
        rows = np.arange(40, dtype=np.float32).reshape(5, 8)
        service.InsertVectors(insert_request("db", "c", rows))
        service.persistence.aof.flush()
        svc2 = ScintireteService(service.config, use_device=False, device="cpu")
        report = svc2.start()
        try:
            assert report["rdb_loaded"] is False
            assert report["aof_commands"] == 3  # create db, create col, insert
        finally:
            svc2.stop()
        assert service.Save(pb.SaveRequest(auth=auth())).snapshot_size > 0
        svc3 = ScintireteService(service.config, use_device=False, device="cpu")
        assert svc3.start()["rdb_loaded"] is True
        try:
            info = svc3.GetCollectionInfo(pb.GetCollectionInfoRequest(
                auth=auth(), db_name="db", collection_name="c"))
            assert info.vector_count == 5
        finally:
            svc3.stop()

    def test_bgsave(self, service):
        resp = service.BgSave(pb.BgSaveRequest(auth=auth()))
        assert resp.success and len(resp.job_id) == 12

    def test_metrics_wiring(self, service):
        service.ListDatabases(pb.ListDatabasesRequest(auth=auth()))
        with pytest.raises(ScintireteError):
            service.ListDatabases(pb.ListDatabasesRequest(auth=auth("bad")))
        assert service.metrics.requests_total.get(method="ListDatabases") == 2
        assert service.metrics.request_errors_total.get(
            method="ListDatabases") == 1
        assert "scintirete_requests_total" in service.metrics.expose_text()

    def test_rate_limit_enforced(self, tmp_path):
        cfg = Config()
        cfg.server.passwords = [PASSWORD]
        cfg.server.rate_limit_rps = 2.0
        cfg.server.rate_limit_burst = 2
        cfg.persistence.data_dir = str(tmp_path / "data")
        svc = ScintireteService(cfg, use_device=False, device="cpu")
        svc.start()
        try:
            for _ in range(2):
                svc.ListDatabases(pb.ListDatabasesRequest(auth=auth()))
            with pytest.raises(ScintireteError) as exc:
                svc.ListDatabases(pb.ListDatabasesRequest(auth=auth()))
            assert exc.value.code == ErrorCode.RATE_LIMITED
        finally:
            svc.stop()

    def test_concurrent_searches_answer_as_one_batch(self, tmp_path):
        """Single-query Search RPCs from many threads ride the batcher's
        waves on the device path; each answer equals its BatchSearch row
        whatever wave it rode in."""
        svc = make_service("cpu", tmp_path / "data")
        try:
            setup_collection(svc, pb.COSINE)
            seed_collection(svc, "db", "c", 3)
            rng = np.random.default_rng(1)
            rows = rng.standard_normal((120, 8)).astype(np.float32)
            svc.InsertVectors(insert_request("db", "c", rows, with_meta=False))
            queries = rows[:24] + 0.05 * rng.standard_normal((24, 8)).astype(
                np.float32)
            batch = svc.BatchSearch(batch_request("db", "c", queries, 4, ef=64))
            want = np.frombuffer(batch.ids_packed, np.uint64).reshape(24, 4)
            got = [None] * 24

            def ask(i):
                r = svc.Search(pb.SearchRequest(
                    auth=auth(), db_name="db", collection_name="c",
                    query_vector=queries[i].tolist(), top_k=4, ef_search=64))
                got[i] = [x.id for x in r.results]

            threads = [threading.Thread(target=ask, args=(i,)) for i in range(24)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert got == want.tolist()
            widths = [w for w, _ in svc.batcher.wave_log]
            assert sum(widths) == 24 and len(widths) < 24
        finally:
            svc.stop()


def test_cuda_service_without_cuda_raises(tmp_path, monkeypatch):
    """The service defaults to the card; without one, the first write
    raises and nothing falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    cfg.server.passwords = [PASSWORD]
    cfg.persistence.data_dir = str(tmp_path / "data")
    svc = ScintireteService(cfg)
    svc.start()
    try:
        assert svc.device == "cuda"
        setup_collection(svc)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            svc.InsertVectors(insert_request(
                "db", "c", np.ones((2, 8), np.float32)))
    finally:
        svc.stop()


# ----- batcher: mirrors of tests/test_batcher.py -----


class TestBatcher:
    def test_coalesces_concurrent_requests(self):
        sizes = []

        def execute(queries):
            sizes.append(len(queries))
            return [float(q[0]) * 2 for q in queries]

        batcher = SearchBatcher(max_batch=64, max_delay_ms=20)
        try:
            results = [None] * 16

            def worker(i):
                results[i] = batcher.submit(
                    "k", np.array([float(i)], np.float32), execute)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert results == [float(i) * 2 for i in range(16)]
            assert len(sizes) < 16 and sum(sizes) == 16
            assert [w for w, _ in batcher.wave_log] == sizes
        finally:
            batcher.stop()

    def test_max_batch_flushes_immediately(self):
        batcher = SearchBatcher(max_batch=4, max_delay_ms=10_000)
        try:
            threads = [threading.Thread(target=lambda: batcher.submit(
                "k", np.zeros(2, np.float32), lambda q: [0.0] * len(q)))
                for _ in range(4)]
            t0 = time.time()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=5)
            assert time.time() - t0 < 5
        finally:
            batcher.stop()

    def test_errors_and_dims_isolated(self):
        """A wrong-dimension query fails alone; a failing group's error
        reaches each of its waiters."""
        def execute(queries):
            if queries.shape[1] != 4:
                raise ValueError("bad dim batch")
            return [1.0] * len(queries)

        batcher = SearchBatcher(max_batch=64, max_delay_ms=20)
        try:
            results, errors = {}, {}

            def worker(i, dim):
                try:
                    results[i] = batcher.submit(
                        "k", np.zeros(dim, np.float32), execute)
                except ValueError as exc:
                    errors[i] = str(exc)

            threads = [threading.Thread(target=worker,
                                        args=(i, 4 if i != 3 else 7))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert sorted(results) == [0, 1, 2, 4, 5, 6, 7]
            assert errors == {3: "bad dim batch"}
        finally:
            batcher.stop()

    def test_disabled_mode_direct(self):
        batcher = SearchBatcher(enabled=False)
        assert batcher.submit(
            "k", np.array([3.0], np.float32), lambda q: [float(q[0, 0])]
        ) == 3.0


# ----- config: mirrors of tests/test_types_config.py -----


class TestConfig:
    def test_template_loads_equal_in_both_packages(self):
        ours, theirs = load_config(TEMPLATE), jax_load_config(TEMPLATE)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert dataclasses.asdict(load_config(None)) == dataclasses.asdict(
            jax_load_config(None))

    def test_reference_style_toml(self, tmp_path):
        path = tmp_path / "cfg.toml"
        path.write_text(
            '[server]\ngrpc_port = 19090\nhttp_port = 18080\n'
            'passwords = ["pw1"]\n[persistence]\ndata_dir = "./data"\n'
            '[[embedding.models]]\nid = "e"\ndimension = 16\n'
            '[algorithm.hnsw_defaults]\nm = 32\n'
            '[tpu]\nplatform = "cpu"\ndevice_dtype = "bfloat16"\n'
            'warm_append_on_start = false\nfuture_knob = 1\n'
        )
        cfg = load_config(str(path))
        assert cfg.server.grpc_port == 19090
        assert cfg.persistence.data_dir == str(tmp_path / "data")
        assert cfg.embedding.models[0].dimension == 16
        assert cfg.default_hnsw_params().m == 32
        assert (cfg.tpu.platform, cfg.tpu.device_dtype) == ("cpu", "bfloat16")
        assert cfg.tpu.warm_append_on_start is False

    @pytest.mark.parametrize("text", [
        '[log]\nlevel = "verbose"\n',
        '[server]\ngrpc_port = "9090"\n',
        "[monitoring]\ninterval = 0\n",
        '[tpu]\nplatform = "tpu"\n',
        '[tpu]\ndefault_index_type = "ivf"\n',
        "[server]\ngrpc_port = 7\nhttp_port = 7\n",
    ])
    def test_invalid_values_are_config_errors(self, tmp_path, text):
        path = tmp_path / "cfg.toml"
        path.write_text(text)
        with pytest.raises(ScintireteError) as exc:
            load_config(str(path))
        assert exc.value.code == ErrorCode.CONFIG

    def test_platform_names_the_device(self, tmp_path):
        path = tmp_path / "cfg.toml"
        for platform in ("", "cuda", "cpu"):
            path.write_text(f'[tpu]\nplatform = "{platform}"\n')
            assert load_config(str(path)).tpu.platform == platform

    def test_missing_file(self):
        with pytest.raises(ScintireteError) as exc:
            load_config("/nonexistent/cfg.toml")
        assert exc.value.code == ErrorCode.CONFIG


# ----- observability: mirrors of tests/test_observability.py -----


class TestObservability:
    def test_audit_events_and_rotation(self, tmp_path):
        path = str(tmp_path / "audit.log")
        audit = AuditLogger(path=path, enabled=True, max_size_bytes=500,
                            max_files=3)
        audit.log_operation("Insert", database="db", collection="c",
                            user_id=hash_user_id("pw"), metadata={"n": 3})
        audit.log_security("Auth", user_id="anonymous")
        first = [json.loads(x) for x in open(path)]
        assert first[0]["level"] == "OPERATION"
        assert first[1]["level"] == "SECURITY"
        for i in range(30):
            audit.log_operation("Op", metadata={"i": i, "pad": "x" * 50})
        audit.close()
        rotated = [f for f in os.listdir(tmp_path) if f.startswith("audit.log.")]
        assert 1 <= len(rotated) <= 2
        assert hash_user_id("") == "anonymous"
        assert len(hash_user_id("secret")) == 16

    def test_monitor_sample_and_thresholds(self):
        buf = io.StringIO()
        log = StructuredLogger(level="warn", fmt="json", stream=buf)
        mon = SystemMonitor(log, memory_threshold_bytes=1, cpu_threshold=1e9,
                            device="cpu")
        sample = mon.sample_once()
        assert sample["rss_bytes"] > 0 and "cpu_utilization" in sample
        assert "device" not in sample  # the CPU's memory is rss_bytes
        warnings = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
        assert any("memory" in w["msg"] for w in warnings)

    def test_device_stats_none_off_the_card(self):
        assert sample_device_stats("cpu") is None

    def test_monitor_interval_clamped(self):
        mon = SystemMonitor(StructuredLogger("error"), interval_seconds=0,
                            enabled=False)
        assert mon.interval >= 1.0
        mon.start()
        assert mon._thread is None
        mon.stop()

    def test_label_escaping(self):
        reg = MetricsRegistry()
        reg.requests_total.inc(collection='a"b\\c\nd')
        line = next(ln for ln in reg.expose_text().splitlines()
                    if ln.startswith("scintirete_requests_total{"))
        assert '\\"' in line and "\\\\" in line and "\\n" in line


# ----- embedding client and rate limiter: mirrors of tests/test_api.py -----


class TestEmbeddingClient:
    def _config(self, url, **kw):
        return EmbeddingConfig(base_url=url, api_key="k", default_model="m", **kw)

    def test_http_error_mapped(self):
        server = FakeEmbeddingServer(fail_with=500)
        try:
            with pytest.raises(ScintireteError) as exc:
                EmbeddingClient(self._config(server.url)).get_embeddings(["x"])
            assert exc.value.code == ErrorCode.EMBEDDING_API_FAILED
        finally:
            server.stop()

    def test_unreachable_mapped(self):
        client = EmbeddingClient(
            self._config("http://127.0.0.1:1/v1/embeddings"), timeout_seconds=0.5)
        with pytest.raises(ScintireteError) as exc:
            client.get_embeddings(["x"])
        assert exc.value.code == ErrorCode.EMBEDDING_TIMEOUT

    def test_rate_limit_enforced(self, fake_embed):
        client = EmbeddingClient(self._config(fake_embed.url, rpm_limit=2))
        client.get_embeddings(["a"])
        client.get_embeddings(["b"])
        with pytest.raises(ScintireteError) as exc:
            client.get_embeddings(["c"])
        assert exc.value.code == ErrorCode.EMBEDDING_QUOTA_EXCEEDED
        assert client.get_embeddings([]) == []


def test_token_bucket():
    lim = TokenBucketLimiter(rps=100.0, burst=3)
    for _ in range(3):
        lim.allow("u")
    with pytest.raises(ScintireteError) as exc:
        lim.allow("u")
    assert exc.value.code == ErrorCode.RATE_LIMITED
    lim.allow("other-key")
    assert lim.get_limit("u") == (100.0, 3.0)
    lim.set_limit("u", 0, 0)
    for _ in range(10):
        lim.allow("u")
    for _ in range(100):
        TokenBucketLimiter(rps=0).allow("u")
