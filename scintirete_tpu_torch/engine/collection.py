"""Collection: a named vector set backed by one index, HNSW or flat
(`config.index_type`). Port of `scintirete_tpu/engine/collection.py` onto
the port's `HNSWIndex` and `FlatIndex`; the collection passes its torch
`device` down to the index.

Capability parity with the reference's Collection
(reference: internal/core/database/collection.go:18-412): server-side
auto-increment ID assignment at insert, dimension validation against the
first stored vector, soft delete, physical Compact (purge + rebuild), deep
Get copies, counts and memory stats.

Design improvement over the reference (flagged in its own memory-bank docs):
vector elements are stored ONCE — in the index's flat array — not duplicated
in a separate map (reference stores them twice: collection.go:130 +
hnsw.go:200). Metadata lives host-side keyed by ID.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Optional, Sequence

import numpy as np

from scintirete_tpu_torch.errors import (
    ErrorCode,
    ScintireteError,
    dimension_mismatch,
)
from scintirete_tpu_torch.index.hnsw import HNSWIndex
from scintirete_tpu_torch.types import (
    CollectionConfig,
    CollectionInfo,
    SearchParams,
    SearchResult,
    Vector,
)
from scintirete_tpu_torch.utils.rwlock import RWLock


class Collection:
    def __init__(self, config: CollectionConfig, use_device: bool = True,
                 tpu_config=None, device="cuda"):
        config.validate()
        if tpu_config is not None and tpu_config.shard_devices > 1:
            raise NotImplementedError(
                "shard_devices > 1 is not ported yet: ROADMAP.md Queue 1, "
                "sharding item (parallel/sharded.py)"
            )
        self.device = device
        self._tpu = tpu_config
        self.config = config
        self.name = config.name
        # readers (search/get/info/export) share; writers serialize on _mu
        # and take _rw.write() only for short state mutations, so searches
        # keep flowing during long index builds (reference: collection.go
        # guards with sync.RWMutex but holds it across whole inserts)
        self._rw = RWLock()
        self._mu = threading.RLock()
        self._dim: Optional[int] = None  # fixed by the first inserted vector
        self._index: Optional[HNSWIndex] = None
        self._metadata: dict[int, Optional[dict[str, Any]]] = {}
        self._deleted_count = 0
        self._next_id = 1  # reference: IDs start at 1; 0 is reserved
        self._use_device = use_device
        self.created_at = time.time()
        self.updated_at = self.created_at
        # process-unique stable identity (request batchers key on it; id()
        # can alias after GC, a uuid cannot)
        self.uid = uuid.uuid4().hex

    # ----- helpers -----

    def _ensure_index(self, dim: int) -> HNSWIndex:
        if self._index is None:
            self._index = self._new_index(dim)
            self._dim = dim
        return self._index

    def _flat_kwargs(self) -> dict[str, Any]:
        """The serving knobs a flat index takes from the `[tpu]` config."""
        if self._tpu is None:
            return {}
        return dict(
            search_batch_size=self._tpu.search_batch_size,
            fast_scan=self._tpu.flat_fast_scan,
        )

    def _new_index(self, dim: int):
        if self.config.index_type == "flat":
            from scintirete_tpu_torch.index.flat import FlatIndex

            return FlatIndex(
                dim=dim,
                params=self.config.hnsw,
                metric=self.config.metric,
                device_dtype=self.config.device_dtype,
                use_device=self._use_device,
                device=self.device,
                **self._flat_kwargs(),
            )
        kwargs = {}
        if self._tpu is not None:
            kwargs = dict(
                search_batch_size=self._tpu.search_batch_size,
                build_chunk_size=self._tpu.build_chunk_size,
                device_search_min_size=self._tpu.device_search_min_size,
            )
        return HNSWIndex(
            dim=dim,
            params=self.config.hnsw,
            metric=self.config.metric,
            device_dtype=self.config.device_dtype,
            use_device=self._use_device,
            device=self.device,
            **kwargs,
        )

    def _check_dim(self, dim: int) -> None:
        if self._dim is not None and dim != self._dim:
            raise dimension_mismatch(self._dim, dim)

    # ----- mutation -----

    def insert(
        self,
        vectors: Sequence[tuple[Sequence[float], Optional[dict[str, Any]]]],
    ) -> list[int]:
        """Insert (elements, metadata) pairs; returns server-assigned IDs
        (reference: collection.go:71-149 — nextID++ per vector)."""
        if not vectors:
            return []
        mats = [np.asarray(e, np.float32) for e, _ in vectors]
        for m in mats:
            if m.ndim != 1:
                raise ScintireteError(
                    ErrorCode.INVALID_PARAMETER, "vector must be 1-D"
                )
        dims = {m.shape[0] for m in mats}
        if len(dims) != 1:
            raise ScintireteError(
                ErrorCode.DIMENSION_MISMATCH,
                f"vectors in one batch have mixed dimensions: {sorted(dims)}",
            )
        dim = dims.pop()
        with self._mu:
            with self._rw.write():
                self._check_dim(dim)
                index = self._ensure_index(dim)
                ids = [self._next_id + i for i in range(len(mats))]
                self._next_id += len(mats)
                # metadata lands BEFORE the vectors become searchable; a
                # concurrent search can then never surface an id whose
                # metadata is missing
                for vid, (_, meta) in zip(ids, vectors):
                    self._metadata[vid] = dict(meta) if meta else None
            try:
                # long build: the index interleaves its own readers at chunk
                # boundaries; the collection read side stays open throughout
                index.bulk_insert(ids, np.stack(mats))
            except BaseException:
                with self._rw.write():
                    for vid in ids:
                        self._metadata.pop(vid, None)
                raise
            with self._rw.write():
                self.updated_at = time.time()
            return ids

    def insert_with_ids(
        self,
        vectors: Sequence[
            tuple[int, Sequence[float], Optional[dict[str, Any]]]
        ],
    ) -> None:
        """Replay/restore path: IDs preserved, next-ID high-water restored
        (reference: collection.go:316-324 updateNextID)."""
        if not vectors:
            return
        ids = [int(vid) for vid, _, _ in vectors]
        mats = np.stack([np.asarray(e, np.float32) for _, e, _ in vectors])
        with self._mu:
            with self._rw.write():
                self._check_dim(mats.shape[1])
                index = self._ensure_index(mats.shape[1])
                for vid, (_, _, meta) in zip(ids, vectors):
                    self._metadata[vid] = dict(meta) if meta else None
                self._next_id = max(self._next_id, max(ids) + 1)
            try:
                index.bulk_insert(ids, mats)
            except BaseException:
                with self._rw.write():
                    for vid in ids:
                        self._metadata.pop(vid, None)
                raise
            with self._rw.write():
                self.updated_at = time.time()

    def delete(self, ids: Sequence[int]) -> int:
        """Soft-delete; returns how many were actually deleted
        (reference: collection.go:152-190 — missing IDs are skipped)."""
        with self._mu, self._rw.write():
            deleted = 0
            if self._index is None:
                return 0
            for vid in ids:
                try:
                    if self._index.delete(int(vid)):
                        # already-tombstoned ids don't count (they'd inflate
                        # deleted_count on every at-least-once AOF replay)
                        deleted += 1
                        self._deleted_count += 1
                except ScintireteError as exc:
                    if exc.code != ErrorCode.VECTOR_NOT_FOUND:
                        raise
            if deleted:
                self.updated_at = time.time()
            return deleted

    def compact(self) -> int:
        """Physically purge tombstones by rebuilding the index from live
        vectors (reference: collection.go:283-313). Returns purged count."""
        with self._mu:
            # _mu excludes all writers for the whole rebuild, so the live
            # set cannot change under us; readers keep searching the OLD
            # index until the atomic swap below
            if self._index is None:
                return 0
            purged = self._deleted_count
            old = self._index
            live_ids = [vid for vid in old.id_to_slot if old.contains(vid)]
            new_index = self._new_index(self._dim)
            if live_ids:
                # one fancy-indexed gather instead of a per-vector
                # get_vector loop (lock + copy per call — minutes at 1M)
                slots = np.fromiter(
                    (old.id_to_slot[vid] for vid in live_ids),
                    np.int64,
                    len(live_ids),
                )
                # an HNSW index keeps its rows in its store, a flat one itself
                arrays = getattr(old, "store", old).vectors
                new_index.bulk_insert(live_ids, arrays[slots].copy())
            with self._rw.write():
                self._index = new_index
                live_set = set(live_ids)
                self._metadata = {
                    vid: meta
                    for vid, meta in self._metadata.items()
                    if vid in live_set
                }
                self._deleted_count = 0
                self.updated_at = time.time()
            return purged

    # ----- reads -----

    def search(
        self, query: Sequence[float], params: SearchParams
    ) -> list[SearchResult]:
        return self.search_batch(
            np.asarray(query, np.float32)[None, :], params
        )[0]

    def search_batch_arrays(
        self, queries: np.ndarray, params: SearchParams
    ) -> tuple[np.ndarray, np.ndarray]:
        """Packed-array search (BatchSearch RPC): (ids u64 [B,k], dists f32
        [B,k]); id 0 / +inf mark missing hits. No metadata, no SearchResult
        objects — response shaping is two tobytes() calls."""
        with self._rw.read():
            queries = np.asarray(queries, np.float32)
            if self._index is None:
                b = queries.shape[0]
                return (np.zeros((b, 0), np.uint64),
                        np.zeros((b, 0), np.float32))
            if queries.shape[-1] != self._dim:
                raise dimension_mismatch(self._dim, int(queries.shape[-1]))
            return self._index.search_batch_arrays(queries, params)

    def search_batch(
        self, queries: np.ndarray, params: SearchParams
    ) -> list[list[SearchResult]]:
        with self._rw.read():
            if self._index is None:
                return [[] for _ in range(len(queries))]
            queries = np.asarray(queries, np.float32)
            if queries.shape[-1] != self._dim:
                raise dimension_mismatch(self._dim, int(queries.shape[-1]))
            raw = self._index.search_batch(queries, params)
            out = []
            for hits in raw:
                results = []
                for vid, dist in hits:
                    meta = self._metadata.get(vid)
                    vec = (
                        self._index.get_vector(vid).tolist()
                        if params.include_vector
                        else None
                    )
                    results.append(
                        SearchResult(
                            id=vid,
                            distance=dist,
                            metadata=dict(meta) if meta else None,
                            vector=vec,
                        )
                    )
                out.append(results)
            return out

    def get(self, vid: int) -> Vector:
        """Deep copy fetch (reference: collection.go:207-239)."""
        with self._rw.read():
            if self._index is None:
                raise ScintireteError(
                    ErrorCode.VECTOR_NOT_FOUND, f"vector not found: {vid}"
                )
            elements = self._index.get_vector(int(vid))  # raises if absent
            meta = self._metadata.get(int(vid))
            return Vector(
                id=int(vid),
                elements=elements.tolist(),
                metadata=dict(meta) if meta else None,
            )

    def get_multiple(self, ids: Sequence[int]) -> list[Vector]:
        out = []
        for vid in ids:
            try:
                out.append(self.get(vid))
            except ScintireteError as exc:
                if exc.code != ErrorCode.VECTOR_NOT_FOUND:
                    raise
        return out

    def has_id(self, vid: int) -> bool:
        """True if the id was ever assigned (tombstoned included)."""
        with self._rw.read():
            return self._index is not None and self._index.has_id(int(vid))

    def count(self) -> int:
        with self._rw.read():
            return self._index.size() if self._index else 0

    def info(self) -> CollectionInfo:
        with self._rw.read():
            return CollectionInfo(
                name=self.name,
                dimension=self._dim or 0,
                vector_count=self.count(),
                deleted_count=self._deleted_count,
                memory_bytes=self._index.memory_bytes() if self._index else 0,
                metric=self.config.metric,
                hnsw=self.config.hnsw,
                index_type=self.config.index_type,
            )

    # ----- persistence bridge -----

    def export_state(self) -> dict[str, Any]:
        with self._rw.read():
            import dataclasses as dc

            state: dict[str, Any] = {
                "config": {
                    "name": self.config.name,
                    "metric": int(self.config.metric),
                    "hnsw": dc.asdict(self.config.hnsw),
                    "device_dtype": self.config.device_dtype,
                    "index_type": self.config.index_type,
                },
                "next_id": self._next_id,
                "deleted_count": self._deleted_count,
                "metadata": {
                    str(k): v for k, v in self._metadata.items() if v is not None
                },
                "graph": self._index.export_graph_state() if self._index else None,
            }
            return state

    @classmethod
    def from_state(cls, state: dict[str, Any], use_device: bool = True,
                   tpu_config=None, device="cuda") -> "Collection":
        from scintirete_tpu_torch.types import DistanceMetric, HNSWParams

        cfg_data = state["config"]
        config = CollectionConfig(
            name=cfg_data["name"],
            metric=DistanceMetric(cfg_data["metric"]),
            hnsw=HNSWParams(**cfg_data["hnsw"]),
            device_dtype=cfg_data.get("device_dtype", "float32"),
            index_type=cfg_data.get("index_type", "hnsw"),
        )
        col = cls(config, use_device=use_device, tpu_config=tpu_config,
                  device=device)
        # restored indexes must honor the same [tpu] serving knobs a fresh
        # _new_index gets (a restart must not change serving behavior)
        hnsw_kw: dict[str, Any] = {}
        if tpu_config is not None:
            hnsw_kw = dict(
                search_batch_size=tpu_config.search_batch_size,
                build_chunk_size=tpu_config.build_chunk_size,
                device_search_min_size=tpu_config.device_search_min_size,
            )
        graph = state.get("graph")
        if graph is not None:
            if graph.get("sharded"):
                raise NotImplementedError(
                    "restoring a sharded collection is not ported yet: "
                    "ROADMAP.md Queue 1, sharding item"
                )
            if graph.get("kind") == "flat":
                from scintirete_tpu_torch.index.flat import FlatIndex

                col._index = FlatIndex.import_graph_state(
                    graph, device_dtype=config.device_dtype,
                    use_device=use_device, device=device,
                    **col._flat_kwargs(),
                )
            else:
                col._index = HNSWIndex.import_graph_state(
                    graph, device_dtype=config.device_dtype,
                    use_device=use_device, device=device, **hnsw_kw,
                )
            col._dim = col._index.dim
        col._next_id = int(state["next_id"])
        col._deleted_count = int(state.get("deleted_count", 0))
        col._metadata = {int(k): v for k, v in state.get("metadata", {}).items()}
        return col
