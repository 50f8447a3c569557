"""The core service: all 16 RPCs and BatchSearch, transport-agnostic.
Port of `scintirete_tpu/server/service.py` onto the port's engine and
persistence; the service runs its engine on an explicit torch `device`.

Capability parity with the reference gRPC server implementation
(reference: internal/server/grpc/{server,database_ops,collection_ops,
vector_ops}.go). Each RPC follows the reference request pattern:
authenticate -> validate -> engine op -> AOF log -> audit log -> metrics ->
response (reference: vector_ops.go:18-103). The gRPC transport and the
HTTP/JSON gateway both delegate to this one object in-process (the reference
HTTP gateway calls gRPC handler methods in-process too,
http/server.go:21-47).

Notable behaviors preserved:
- InsertVectors assigns server-side IDs and returns them
  (vector_ops.go:93-102); an AOF failure fails the request.
- EmbedAndInsert logs to AOF but an AOF failure does NOT fail the request
  (vector_ops.go:334-347).
- Search include_vector elision: vectors only when asked; metadata always
  (vector_ops.go:229-261).
- Save is synchronous; BgSave returns a job id and runs async
  (grpc/server.go:180-303).
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Optional

import numpy as np
from google.protobuf import json_format, struct_pb2

from scintirete_tpu_torch.config import Config
from scintirete_tpu_torch.embedding import EmbeddingClient
from scintirete_tpu_torch.engine import Engine
from scintirete_tpu_torch.errors import ErrorCode, ScintireteError
from scintirete_tpu_torch.observability.audit import AuditLogger, hash_user_id
from scintirete_tpu_torch.observability.logger import StructuredLogger
from scintirete_tpu_torch.observability.metrics import MetricsRegistry
from scintirete_tpu_torch.ops import _ext
from scintirete_tpu_torch.persistence import PersistenceManager
from scintirete_tpu_torch.proto import scintirete_pb2 as pb
from scintirete_tpu_torch.server.auth import BasicAuthenticator
from scintirete_tpu_torch.server.batcher import SearchBatcher
from scintirete_tpu_torch.server.ratelimit import TokenBucketLimiter
from scintirete_tpu_torch.types import (
    CollectionConfig,
    DistanceMetric,
    SearchParams,
)


def struct_to_dict(struct: struct_pb2.Struct) -> Optional[dict[str, Any]]:
    if struct is None or not struct.fields:
        return None
    return json_format.MessageToDict(struct)


def dict_to_struct(data: Optional[dict[str, Any]]) -> Optional[struct_pb2.Struct]:
    if not data:
        return None
    s = struct_pb2.Struct()
    json_format.ParseDict(data, s)
    return s


class ScintireteService:
    """Composition root + all RPC implementations
    (reference composition: grpc/server.go:41-103)."""

    def __init__(
        self,
        config: Config,
        engine: Optional[Engine] = None,
        persistence: Optional[PersistenceManager] = None,
        embedding: Optional[EmbeddingClient] = None,
        logger: Optional[StructuredLogger] = None,
        audit: Optional[AuditLogger] = None,
        metrics: Optional[MetricsRegistry] = None,
        use_device: bool = True,
        device="cuda",
    ):
        self.config = config
        self.device = device
        self.logger = logger or StructuredLogger.from_config(config.log)
        self.engine = engine or Engine(
            use_device=use_device, tpu_config=config.tpu, device=device
        )
        self.persistence = persistence or PersistenceManager(
            self.engine,
            config.persistence.data_dir,
            rdb_filename=config.persistence.rdb_filename,
            aof_filename=config.persistence.aof_filename,
            aof_sync_strategy=config.persistence.aof_sync_strategy,
            rdb_interval_seconds=config.persistence.rdb_interval_minutes * 60,
            aof_rewrite_size_bytes=config.persistence.aof_rewrite_size_mb * 1024 * 1024,
            strict_recovery=config.persistence.strict_recovery,
            logger=self.logger,
        )
        self.embedding = embedding or EmbeddingClient(config.embedding)
        self.auth = BasicAuthenticator(config.server.passwords)
        self.rate_limiter = TokenBucketLimiter(
            config.server.rate_limit_rps,
            config.server.rate_limit_burst or None,
        )
        self.audit = audit or AuditLogger(enabled=False)
        self.metrics = metrics or MetricsRegistry()
        self._use_device = use_device
        self._warm_thread = None
        self._warm_info: Optional[dict[str, Any]] = None
        self._warm_error: Optional[str] = None
        # coalesce concurrent single-query RPCs into one device dispatch
        # (the device path, on the card or in the plain torch versions)
        self.batcher = SearchBatcher(
            max_batch=config.tpu.search_batch_size,
            max_delay_ms=2.0,
            enabled=use_device,
        )
        self._started = False

    # ----- lifecycle (reference: grpc/server.go:106-130) -----

    def start(self) -> dict[str, Any]:
        result = self.persistence.recover()
        self.persistence.start_background_tasks()
        self._started = True
        if self._use_device and self.config.tpu.warm_search_on_start:
            import threading

            self._warm_thread = threading.Thread(
                target=self._warm_search, daemon=True
            )
            self._warm_thread.start()
        self.logger.info("service started", **result)
        return result

    def _warm_search(self) -> None:
        """Search every restored collection once, at `search_batch_size`
        queries, in the background: the first search of a collection
        uploads its device mirror, which the first client query would
        otherwise pay. The queries are seeded normal rows (a zero query has
        no cosine direction). Runs off the serving critical path; a failure
        only warns (and is kept in `_warm_error`): the first real query then
        pays what the warm-up could not."""
        t0 = time.time()
        width = self.config.tpu.search_batch_size
        warmed = 0
        try:
            params = SearchParams(top_k=10)
            rng = np.random.default_rng(0)
            for dbname in self.engine.list_databases():
                db = self.engine.get_database(dbname)
                for col in db.collections():
                    info = col.info()
                    if info.vector_count == 0 or info.dimension == 0:
                        continue
                    q = rng.standard_normal((width, info.dimension))
                    col.search_batch_arrays(q.astype(np.float32), params)
                    warmed += 1
            self._warm_info = {
                "collections": warmed,
                "width": width,
                "seconds": round(time.time() - t0, 3),
                # the kernel libraries' first load, wherever it happened
                "kernel_load_s": _ext.load_seconds,
            }
            if warmed:
                self.logger.info("search prewarm done", **self._warm_info)
        except Exception as exc:  # never let warmup break serving
            self._warm_error = repr(exc)
            self.logger.warn("search prewarm failed", error=str(exc))

    def stop(self) -> None:
        self.batcher.stop()
        self.persistence.stop()
        self.audit.close()
        self._started = False
        self.logger.info("service stopped")

    # ----- shared helpers -----

    def _begin(self, method: str, auth: pb.AuthInfo) -> tuple[float, str]:
        self.auth.authenticate(auth.password if auth else "")
        user = hash_user_id(auth.password if auth else "")
        self.rate_limiter.allow(user)
        return time.time(), user

    def _finish(self, method: str, t0: float, error: bool = False) -> None:
        self.metrics.observe_request(method, time.time() - t0, error)

    def _audit_op(self, op: str, user: str, db: str = "", col: str = "", **meta):
        self.audit.log_operation(
            op, database=db, collection=col, user_id=user, metadata=meta or None
        )

    def _instrumented(self, method: str, auth, fn):
        try:
            t0, user = self._begin(method, auth)
        except ScintireteError:
            self.metrics.observe_request(method, 0.0, True)
            self.audit.log_security(
                method, user_id="anonymous", metadata={"reason": "auth_failed"}
            )
            raise
        try:
            result = fn(user)
        except Exception:
            self._finish(method, t0, error=True)
            raise
        self._finish(method, t0)
        return result

    @staticmethod
    def _require(cond: bool, message: str) -> None:
        if not cond:
            raise ScintireteError(ErrorCode.INVALID_PARAMETER, message)

    def _collection(self, db_name: str, collection_name: str):
        self._require(bool(db_name), "db_name is required")
        self._require(bool(collection_name), "collection_name is required")
        return self.engine.get_database(db_name).get_collection(collection_name)

    def _collection_info_pb(self, info) -> pb.CollectionInfo:
        return pb.CollectionInfo(
            name=info.name,
            dimension=info.dimension,
            vector_count=info.vector_count,
            deleted_count=info.deleted_count,
            memory_bytes=info.memory_bytes,
            metric_type=int(info.metric),
            hnsw_config=pb.HnswConfig(
                m=info.hnsw.m, ef_construction=info.hnsw.ef_construction
            ),
            index_type=info.index_type,
        )

    # ----- database RPCs (reference: grpc/database_ops.go) -----

    def CreateDatabase(self, req: pb.CreateDatabaseRequest) -> pb.CreateDatabaseResponse:
        def op(user):
            self._require(bool(req.name), "database name is required")
            self.engine.create_database(req.name)
            self.persistence.log_create_database(req.name)
            self._audit_op("CreateDatabase", user, db=req.name)
            return pb.CreateDatabaseResponse(
                name=req.name, success=True, message="database created"
            )

        return self._instrumented("CreateDatabase", req.auth, op)

    def DropDatabase(self, req: pb.DropDatabaseRequest) -> pb.DropDatabaseResponse:
        def op(user):
            self._require(bool(req.name), "database name is required")
            db = self.engine.get_database(req.name)
            ncols = len(db.list_collections())
            self.engine.drop_database(req.name)
            self.persistence.log_drop_database(req.name)
            self._audit_op("DropDatabase", user, db=req.name)
            return pb.DropDatabaseResponse(
                name=req.name,
                success=True,
                message="database dropped",
                dropped_collections=ncols,
            )

        return self._instrumented("DropDatabase", req.auth, op)

    def ListDatabases(self, req: pb.ListDatabasesRequest) -> pb.ListDatabasesResponse:
        def op(user):
            return pb.ListDatabasesResponse(names=self.engine.list_databases())

        return self._instrumented("ListDatabases", req.auth, op)

    # ----- collection RPCs (reference: grpc/collection_ops.go) -----

    def CreateCollection(
        self, req: pb.CreateCollectionRequest
    ) -> pb.CreateCollectionResponse:
        def op(user):
            self._require(bool(req.db_name), "db_name is required")
            self._require(bool(req.collection_name), "collection_name is required")
            metric = DistanceMetric(req.metric_type)
            defaults = self.config.default_hnsw_params()
            if req.HasField("hnsw_config"):
                # carry ALL server defaults (notably neighbor_heuristic and
                # max_layers) and override only the fields the proto exposes —
                # a partial HNSWParams here would silently disable the
                # diversity heuristic for client-configured collections
                hnsw = dataclasses.replace(
                    defaults,
                    m=req.hnsw_config.m or defaults.m,
                    ef_construction=req.hnsw_config.ef_construction
                    or defaults.ef_construction,
                )
            else:
                hnsw = defaults
            index_type = req.index_type or self.config.tpu.default_index_type
            cfg = CollectionConfig(
                name=req.collection_name,
                metric=metric,
                hnsw=hnsw,
                device_dtype=self.config.tpu.device_dtype,
                index_type=index_type,
            )
            cfg.validate()
            db = self.engine.get_database(req.db_name)
            col = db.create_collection(cfg)
            self.persistence.log_create_collection(
                req.db_name,
                req.collection_name,
                {
                    "metric": int(metric),
                    # full params (incl. neighbor_heuristic) so an AOF-replayed
                    # collection is built with the same selection rule
                    "hnsw": dataclasses.asdict(hnsw),
                    "device_dtype": cfg.device_dtype,
                    "index_type": cfg.index_type,
                },
            )
            self._audit_op(
                "CreateCollection", user, db=req.db_name, col=req.collection_name
            )
            return pb.CreateCollectionResponse(
                db_name=req.db_name,
                collection_name=req.collection_name,
                success=True,
                message="collection created",
                info=self._collection_info_pb(col.info()),
            )

        return self._instrumented("CreateCollection", req.auth, op)

    def DropCollection(self, req: pb.DropCollectionRequest) -> pb.DropCollectionResponse:
        def op(user):
            col = self._collection(req.db_name, req.collection_name)
            nvecs = col.count()
            self.engine.get_database(req.db_name).drop_collection(req.collection_name)
            self.persistence.log_drop_collection(req.db_name, req.collection_name)
            self._audit_op(
                "DropCollection", user, db=req.db_name, col=req.collection_name
            )
            return pb.DropCollectionResponse(
                db_name=req.db_name,
                collection_name=req.collection_name,
                success=True,
                message="collection dropped",
                dropped_vectors=nvecs,
            )

        return self._instrumented("DropCollection", req.auth, op)

    def GetCollectionInfo(self, req: pb.GetCollectionInfoRequest) -> pb.CollectionInfo:
        def op(user):
            col = self._collection(req.db_name, req.collection_name)
            return self._collection_info_pb(col.info())

        return self._instrumented("GetCollectionInfo", req.auth, op)

    def ListCollections(self, req: pb.ListCollectionsRequest) -> pb.ListCollectionsResponse:
        def op(user):
            self._require(bool(req.db_name), "db_name is required")
            db = self.engine.get_database(req.db_name)
            infos = [
                self._collection_info_pb(db.get_collection(name).info())
                for name in db.list_collections()
            ]
            return pb.ListCollectionsResponse(collections=infos)

        return self._instrumented("ListCollections", req.auth, op)

    # ----- vector RPCs (reference: grpc/vector_ops.go) -----

    def InsertVectors(self, req: pb.InsertVectorsRequest) -> pb.InsertVectorsResponse:
        def op(user):
            col = self._collection(req.db_name, req.collection_name)
            self._require(len(req.vectors) > 0, "vectors must not be empty")
            pairs = [
                (list(v.elements), struct_to_dict(v.metadata)) for v in req.vectors
            ]
            ids = col.insert(pairs)
            self.persistence.log_insert_vectors(
                req.db_name,
                req.collection_name,
                [
                    {"id": vid, "elements": elems, "metadata": meta}
                    for vid, (elems, meta) in zip(ids, pairs)
                ],
            )
            self.metrics.vector_operations_total.inc(
                len(ids), operation="insert", collection=req.collection_name
            )
            self._update_collection_gauges(req.collection_name, col)
            self._audit_op(
                "InsertVectors",
                user,
                db=req.db_name,
                col=req.collection_name,
                count=len(ids),
            )
            return pb.InsertVectorsResponse(
                inserted_ids=ids, inserted_count=len(ids)
            )

        return self._instrumented("InsertVectors", req.auth, op)

    def DeleteVectors(self, req: pb.DeleteVectorsRequest) -> pb.DeleteVectorsResponse:
        def op(user):
            col = self._collection(req.db_name, req.collection_name)
            self._require(len(req.ids) > 0, "ids must not be empty")
            deleted = col.delete(list(req.ids))
            self.persistence.log_delete_vectors(
                req.db_name, req.collection_name, list(req.ids)
            )
            self.metrics.vector_operations_total.inc(
                deleted, operation="delete", collection=req.collection_name
            )
            self._update_collection_gauges(req.collection_name, col)
            self._audit_op(
                "DeleteVectors",
                user,
                db=req.db_name,
                col=req.collection_name,
                count=deleted,
            )
            return pb.DeleteVectorsResponse(deleted_count=deleted)

        return self._instrumented("DeleteVectors", req.auth, op)

    def Search(self, req: pb.SearchRequest) -> pb.SearchResponse:
        def op(user):
            col = self._collection(req.db_name, req.collection_name)
            self._require(len(req.query_vector) > 0, "query_vector is required")
            self._require(req.top_k > 0, "top_k must be > 0")
            params = SearchParams(
                top_k=req.top_k,
                ef_search=req.ef_search if req.HasField("ef_search") else None,
                include_vector=(
                    req.include_vector if req.HasField("include_vector") else False
                ),
            )
            results = self._batched_search(
                col, np.asarray(req.query_vector, np.float32), params
            )
            self.metrics.vector_operations_total.inc(
                operation="search", collection=req.collection_name
            )
            return pb.SearchResponse(
                results=[self._result_item_pb(r, params.include_vector) for r in results]
            )

        return self._instrumented("Search", req.auth, op)

    def BatchSearch(self, req: pb.BatchSearchRequest) -> pb.BatchSearchResponse:
        """Packed-payload batched search (extension; see the proto).

        The reference-compatible Search RPC pays per-float proto decode on
        `repeated float` and per-hit message construction. Here queries
        arrive as one little-endian bytes blob (f32 or f16) and results
        leave as two blobs; the only per-request Python costs are
        np.frombuffer views and two tobytes()."""

        def op(user):
            col = self._collection(req.db_name, req.collection_name)
            self._require(req.num_queries > 0, "num_queries must be > 0")
            self._require(req.dim > 0, "dim must be > 0")
            self._require(req.top_k > 0, "top_k must be > 0")
            dtype = np.dtype(np.float16 if req.dtype == "f16" else np.float32)
            self._require(
                req.dtype in ("", "f32", "f16"),
                f"unsupported dtype {req.dtype!r} (want f32 or f16)",
            )
            expect = req.num_queries * req.dim * dtype.itemsize
            self._require(
                len(req.queries_packed) == expect,
                f"queries_packed is {len(req.queries_packed)} bytes, "
                f"want {expect} for {req.num_queries}x{req.dim} {dtype}",
            )
            queries = np.frombuffer(req.queries_packed, dtype).reshape(
                req.num_queries, req.dim
            )
            if dtype == np.float16:
                queries = queries.astype(np.float32)
            params = SearchParams(
                top_k=req.top_k,
                ef_search=req.ef_search if req.HasField("ef_search") else None,
            )
            ids, dists = col.search_batch_arrays(queries, params)
            self.metrics.vector_operations_total.inc(
                operation="search", collection=req.collection_name
            )
            return pb.BatchSearchResponse(
                ids_packed=np.ascontiguousarray(ids).tobytes(),
                distances_packed=np.ascontiguousarray(dists).tobytes(),
                num_queries=int(ids.shape[0]),
                top_k=int(ids.shape[1]),
            )

        return self._instrumented("BatchSearch", req.auth, op)

    def _batched_search(self, col, query, params):
        key = (col.uid, params.top_k, params.ef_search, params.include_vector)
        return self.batcher.submit(
            key, query, lambda queries: col.search_batch(queries, params)
        )

    def _result_item_pb(self, r, include_vector: bool) -> pb.SearchResultItem:
        item = pb.SearchResultItem(distance=r.distance, id=r.id)
        if include_vector:
            vec = pb.Vector(id=r.id, elements=r.vector or [])
            meta = dict_to_struct(r.metadata)
            if meta is not None:
                vec.metadata.CopyFrom(meta)
            item.vector.CopyFrom(vec)
        else:
            meta = dict_to_struct(r.metadata)
            if meta is not None:
                item.metadata.CopyFrom(meta)
        return item

    def _update_collection_gauges(self, name: str, col) -> None:
        info = col.info()
        self.metrics.vector_count.set(info.vector_count, collection=name)
        self.metrics.memory_usage_bytes.set(info.memory_bytes, collection=name)

    # ----- text RPCs (reference: grpc/vector_ops.go:280-545) -----

    def EmbedAndInsert(self, req: pb.EmbedAndInsertRequest) -> pb.EmbedAndInsertResponse:
        def op(user):
            col = self._collection(req.db_name, req.collection_name)
            self._require(len(req.texts) > 0, "texts must not be empty")
            model = (
                req.embedding_model if req.HasField("embedding_model") else None
            )
            texts = [t.text for t in req.texts]
            metas = [struct_to_dict(t.metadata) for t in req.texts]
            pairs = self.embedding.texts_to_vectors(texts, metas, model)
            ids = col.insert(pairs)
            # AOF failure is logged but does not fail the request
            # (reference: vector_ops.go:334-347)
            try:
                self.persistence.log_insert_vectors(
                    req.db_name,
                    req.collection_name,
                    [
                        {"id": vid, "elements": elems, "metadata": meta}
                        for vid, (elems, meta) in zip(ids, pairs)
                    ],
                )
            except ScintireteError as exc:
                self.logger.error("AOF log failed for EmbedAndInsert", error=str(exc))
            self.metrics.vector_operations_total.inc(
                len(ids), operation="insert", collection=req.collection_name
            )
            self._audit_op(
                "EmbedAndInsert",
                user,
                db=req.db_name,
                col=req.collection_name,
                count=len(ids),
            )
            return pb.EmbedAndInsertResponse(inserted_ids=ids, inserted_count=len(ids))

        return self._instrumented("EmbedAndInsert", req.auth, op)

    def EmbedAndSearch(self, req: pb.EmbedAndSearchRequest) -> pb.SearchResponse:
        def op(user):
            col = self._collection(req.db_name, req.collection_name)
            self._require(bool(req.query_text), "query_text is required")
            self._require(req.top_k > 0, "top_k must be > 0")
            model = (
                req.embedding_model if req.HasField("embedding_model") else None
            )
            embedding = self.embedding.get_single_embedding(req.query_text, model)
            params = SearchParams(
                top_k=req.top_k,
                ef_search=req.ef_search if req.HasField("ef_search") else None,
                include_vector=(
                    req.include_vector if req.HasField("include_vector") else False
                ),
            )
            results = self._batched_search(
                col, np.asarray(embedding, np.float32), params
            )
            return pb.SearchResponse(
                results=[self._result_item_pb(r, params.include_vector) for r in results]
            )

        return self._instrumented("EmbedAndSearch", req.auth, op)

    def EmbedText(self, req: pb.EmbedTextRequest) -> pb.EmbedTextResponse:
        def op(user):
            self._require(len(req.texts) > 0, "texts must not be empty")
            model = (
                req.embedding_model if req.HasField("embedding_model") else None
            )
            embeddings = self.embedding.get_embeddings(list(req.texts), model)
            return pb.EmbedTextResponse(
                results=[
                    pb.EmbedTextResult(text=t, embedding=e, index=i)
                    for i, (t, e) in enumerate(zip(req.texts, embeddings))
                ]
            )

        return self._instrumented("EmbedText", req.auth, op)

    def ListEmbeddingModels(
        self, req: pb.ListEmbeddingModelsRequest
    ) -> pb.ListEmbeddingModelsResponse:
        def op(user):
            return pb.ListEmbeddingModelsResponse(
                models=[
                    pb.EmbeddingModel(
                        id=m.id,
                        name=m.name,
                        dimension=m.dimension,
                        available=m.available,
                        description=m.description,
                    )
                    for m in self.embedding.get_models()
                ],
                default_model=self.embedding.get_default_model(),
            )

        return self._instrumented("ListEmbeddingModels", req.auth, op)

    # ----- persistence RPCs (reference: grpc/server.go:180-303) -----

    def Save(self, req: pb.SaveRequest) -> pb.SaveResponse:
        def op(user):
            t0 = time.time()
            self.persistence.save_snapshot()
            self._audit_op("Save", user)
            return pb.SaveResponse(
                success=True,
                message="snapshot saved",
                snapshot_size=self.persistence.rdb.size_bytes(),
                duration_seconds=time.time() - t0,
            )

        return self._instrumented("Save", req.auth, op)

    def BgSave(self, req: pb.BgSaveRequest) -> pb.BgSaveResponse:
        def op(user):
            job_id = uuid.uuid4().hex[:12]
            self.persistence.background_save()
            self._audit_op("BgSave", user, job_id=job_id)
            return pb.BgSaveResponse(
                success=True, message="background save started", job_id=job_id
            )

        return self._instrumented("BgSave", req.auth, op)


# All RPC method names, used by both transports to wire handlers.
RPC_METHODS = (
    "CreateDatabase",
    "DropDatabase",
    "ListDatabases",
    "CreateCollection",
    "DropCollection",
    "GetCollectionInfo",
    "ListCollections",
    "InsertVectors",
    "DeleteVectors",
    "Search",
    "EmbedAndInsert",
    "EmbedAndSearch",
    "EmbedText",
    "ListEmbeddingModels",
    "Save",
    "BgSave",
    "BatchSearch",  # packed-payload extension (not in the reference 16)
)

# request / response types per method (GetCollectionInfo returns CollectionInfo,
# EmbedAndSearch returns SearchResponse — reference: scintirete.proto:14-56)
RPC_TYPES = {
    "CreateDatabase": (pb.CreateDatabaseRequest, pb.CreateDatabaseResponse),
    "DropDatabase": (pb.DropDatabaseRequest, pb.DropDatabaseResponse),
    "ListDatabases": (pb.ListDatabasesRequest, pb.ListDatabasesResponse),
    "CreateCollection": (pb.CreateCollectionRequest, pb.CreateCollectionResponse),
    "DropCollection": (pb.DropCollectionRequest, pb.DropCollectionResponse),
    "GetCollectionInfo": (pb.GetCollectionInfoRequest, pb.CollectionInfo),
    "ListCollections": (pb.ListCollectionsRequest, pb.ListCollectionsResponse),
    "InsertVectors": (pb.InsertVectorsRequest, pb.InsertVectorsResponse),
    "DeleteVectors": (pb.DeleteVectorsRequest, pb.DeleteVectorsResponse),
    "Search": (pb.SearchRequest, pb.SearchResponse),
    "EmbedAndInsert": (pb.EmbedAndInsertRequest, pb.EmbedAndInsertResponse),
    "EmbedAndSearch": (pb.EmbedAndSearchRequest, pb.SearchResponse),
    "EmbedText": (pb.EmbedTextRequest, pb.EmbedTextResponse),
    "ListEmbeddingModels": (
        pb.ListEmbeddingModelsRequest,
        pb.ListEmbeddingModelsResponse,
    ),
    "Save": (pb.SaveRequest, pb.SaveResponse),
    "BgSave": (pb.BgSaveRequest, pb.BgSaveResponse),
    "BatchSearch": (pb.BatchSearchRequest, pb.BatchSearchResponse),
}
