"""HNSWIndex: the public index type (ids in, results out). Port of
`scintirete_tpu/index/hnsw.py`.

Search runs the batched search (device.py) on the index's torch device:
pivot entry by default, or the descent through the upper layers
(`entry_mode="descent"`, from the mid-entry layer unless `descent_mid` is
False, `ef_upper` wide); mutations go through the host store and the
device mirror re-syncs lazily (version keyed). `bulk_insert` picks one of
four paths, as the JAX package does: the exact-kNN build (knn_build.build,
its upper layers by `upper_mode`: "knn" or "seq") into an empty index, or
of the union when an append at least quadruples the collection; the
batched append (knn_build.append_batch) onto a built
graph; otherwise chunked device insertion (bulk.py with
DeviceIndex.build_descent), or host inserts for small batches.

Concurrency model: readers share an RWLock; writers serialize on a
separate mutex and take the write side only for short mutation sections.
A bulk build assembles into a detached store off-lock, and an append into
a clone of the store off-lock; each publishes with one atomic swap.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Sequence

import numpy as np
import torch

from scintirete_tpu_torch.errors import ErrorCode, ScintireteError, dimension_mismatch
from scintirete_tpu_torch.observability import trace
from scintirete_tpu_torch.types import DistanceMetric, HNSWParams, SearchParams
from scintirete_tpu_torch.utils.rwlock import RWLock
from scintirete_tpu_torch.index import host_algo
from scintirete_tpu_torch.index.store import GraphStore, LayerStore


@dataclasses.dataclass
class GraphStats:
    nodes: int
    connections: int
    avg_degree: float
    max_layer: int
    memory_bytes: int


# an append this large (and at least 4x the existing collection) is
# rebuilt as a fresh exact-kNN graph of the union
REBUILD_APPEND_MIN = 16384


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device an index runs on. A CUDA device on a machine
    without CUDA raises: there is no fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class HNSWIndex:
    """Thread-safe HNSW index keyed by uint64 vector IDs."""

    def __init__(
        self,
        dim: int,
        params: HNSWParams | None = None,
        metric: DistanceMetric = DistanceMetric.COSINE,
        device_dtype: str = "float32",
        use_device: bool = True,
        search_batch_size: int = 256,
        device_search_min_size: int = 0,
        device: str | torch.device = "cuda",
        build_chunk_size: int = 1024,
        entry_mode: str = "pivot",
        ef_upper: int = 1,
        descent_mid: bool = True,
        upper_mode: str = "knn",
    ):
        params = params or HNSWParams()
        params.validate()
        if entry_mode not in ("pivot", "descent"):
            raise ValueError(f"entry_mode must be 'pivot' or 'descent', "
                             f"not {entry_mode!r}")
        if upper_mode not in ("knn", "seq"):
            raise ValueError(f"upper_mode must be 'knn' or 'seq', "
                             f"not {upper_mode!r}")
        self.device = resolve_device(device)
        self.store = GraphStore(dim, params, metric)
        self.id_to_slot: dict[int, int] = {}
        self.slot_to_id: np.ndarray = np.zeros(self.store.cap, np.uint64)
        self.device_dtype = device_dtype
        self.use_device = use_device
        self.search_batch_size = search_batch_size
        self.build_chunk_size = build_chunk_size
        # below this many live vectors, searches stay on the host
        self.device_search_min_size = device_search_min_size
        # search entry (DeviceIndex.search_submit): "pivot", or "descent"
        # through the upper layers, from the mid-entry layer when
        # descent_mid, `ef_upper` wide above layer 0
        self.entry_mode = entry_mode
        self.ef_upper = ef_upper
        self.descent_mid = descent_mid
        # upper-layer constructor of a bulk build (knn_build.build)
        self.upper_mode = upper_mode
        # phase seconds and counts of the last bulk build (knn_build.build)
        self.build_stats: dict = {}
        self._device = None  # lazy DeviceIndex
        # device-resident scan base + layer-0 adjacency kept between
        # appends (knn_build.append_batch); build() re-seeds it
        self._append_scan_cache: dict = {}
        self._rw = RWLock()
        # writer-writer serialization across whole operations
        self._write_mu = threading.RLock()

    # ----- properties -----

    @property
    def dim(self) -> int:
        return self.store.dim

    @property
    def params(self) -> HNSWParams:
        return self.store.params

    @property
    def metric(self) -> DistanceMetric:
        return self.store.metric

    def size(self) -> int:
        with self._rw.read():
            return self.store.live

    def memory_bytes(self) -> int:
        with self._rw.read():
            return self.store.memory_bytes() + 8 * len(self.id_to_slot)

    def set_ef_search(self, ef: int) -> None:
        with self._write_mu, self._rw.write():
            p = self.store.params
            self.store.params = dataclasses.replace(p, ef_search=ef)

    def stats(self) -> GraphStats:
        with self._rw.read():
            conns = self.store.connection_count()
            n = max(self.store.live, 1)
            return GraphStats(
                nodes=self.store.live,
                connections=conns,
                avg_degree=conns / n,
                max_layer=self.store.max_layer,
                memory_bytes=self.memory_bytes(),
            )

    # ----- mutation -----

    def insert(self, vector_id: int, elements: Sequence[float]) -> None:
        with self._write_mu, self._rw.write():
            if vector_id in self.id_to_slot:
                raise ScintireteError(
                    ErrorCode.INVALID_PARAMETER,
                    f"vector with ID {vector_id} already exists",
                )
            vec = np.asarray(elements, np.float32)
            if vec.ndim != 1 or vec.shape[0] != self.store.dim:
                raise dimension_mismatch(self.store.dim, int(vec.shape[-1]))
            slot = host_algo.insert(self.store, vec)
            self._register_slot(vector_id, slot)

    def bulk_insert(self, ids: Sequence[int], vectors: np.ndarray) -> None:
        """Bulk insert: from-scratch builds of device-eligible size, and
        appends that at least quadruple the collection, use the exact-kNN
        constructor (knn_build.build); appends onto a built graph of at
        least APPEND_MIN vectors (or 64 once the graph holds 200,000) take
        the batched append (knn_build.append_batch); everything else takes
        the chunked device-assisted path (bulk.py)."""
        from scintirete_tpu_torch.index import bulk, knn_build

        with self._write_mu:
            seen: set[int] = set()
            for vid in ids:
                v = int(vid)
                # within-batch repeats would register two slots under one id
                if v in self.id_to_slot or v in seen:
                    raise ScintireteError(
                        ErrorCode.INVALID_PARAMETER,
                        f"vector with ID {vid} already exists",
                    )
                seen.add(v)
            vectors = np.asarray(vectors, np.float32)
            if vectors.ndim != 2 or vectors.shape[1] != self.store.dim:
                raise dimension_mismatch(self.store.dim, int(vectors.shape[-1]))
            if (
                self.use_device
                and self.store.count == 0
                and len(vectors) >= knn_build.MIN_BUILD_SIZE
            ):
                # from-scratch build into a detached store, no locks held,
                # then one atomic swap
                tmp = GraphStore(
                    self.store.dim, self.store.params, self.store.metric
                )
                slots = knn_build.build(
                    tmp, vectors, self.device,
                    scan_cache=self._append_scan_cache, **self._build_args(),
                )
                with self._rw.write():
                    self.store = tmp
                    self._device = None  # fresh mirror -> full upload
                    for vid, slot in zip(ids, slots):
                        self._register_slot(int(vid), int(slot))
            elif (
                self.use_device
                and self.store.live == self.store.count  # no tombstones
                and len(vectors)
                >= max(4 * self.store.count, REBUILD_APPEND_MIN)
            ):
                # append at least quadruples the collection: rebuild the
                # UNION with the kNN constructor, published with one swap
                n_old = self.store.count
                old_ids = self.slot_to_id[:n_old].astype(np.uint64)
                all_vecs = np.concatenate(
                    [self.store.vectors[:n_old], vectors]
                )
                tmp = GraphStore(
                    self.store.dim, self.store.params, self.store.metric
                )
                slots = knn_build.build(
                    tmp, all_vecs, self.device,
                    scan_cache=self._append_scan_cache, **self._build_args(),
                )
                all_ids = [int(v) for v in old_ids] + [int(v) for v in ids]
                new_map = dict(zip(all_ids, (int(s) for s in slots)))
                new_rev = np.zeros(tmp.cap, np.uint64)
                new_rev[np.asarray(slots)] = all_ids
                with self._rw.write():
                    self.store = tmp
                    self._device = None
                    self.id_to_slot = new_map
                    self.slot_to_id = new_rev
            elif (
                self.use_device
                and self.store.count >= knn_build.MIN_BUILD_SIZE
                and (
                    len(vectors) >= knn_build.APPEND_MIN
                    # on large graphs even small appends go batched: the
                    # chunked path's per-vector linking degrades there
                    or (self.store.count >= 200_000 and len(vectors) >= 64)
                )
            ):
                # batched append into a CLONE off-lock (readers keep the
                # old store), published with one swap. The clone continues
                # dirty tracking, so the kept mirror (self._device)
                # scatters only the rows the append touched
                tmp = self.store.clone(track_dirty=True, share_append_safe=True)
                slots = knn_build.append_batch(
                    tmp, vectors, self.device,
                    scan_cache=self._append_scan_cache,
                )
                with self._rw.write():
                    self.store = tmp
                    for vid, slot in zip(ids, slots):
                        self._register_slot(int(vid), int(slot))
            else:
                device = self._get_device() if self.use_device else None
                id_iter = iter(ids)

                def on_slots(new_slots):
                    # called inside a write section: ids become searchable
                    # atomically with their links
                    for slot in new_slots:
                        self._register_slot(int(next(id_iter)), int(slot))

                bulk.bulk_insert(
                    self.store, vectors, device=device,
                    chunk_size=self.build_chunk_size,
                    write_ctx=self._rw.write, on_slots=on_slots,
                )

    def _build_args(self) -> dict:
        self.build_stats = {}
        return {"upper_mode": self.upper_mode, "stats": self.build_stats}

    def _register_slot(self, vector_id: int, slot: int) -> None:
        self.id_to_slot[vector_id] = slot
        if self.slot_to_id.shape[0] < self.store.cap:
            new = np.zeros(self.store.cap, np.uint64)
            new[: self.slot_to_id.shape[0]] = self.slot_to_id
            self.slot_to_id = new
        self.slot_to_id[slot] = vector_id

    def delete(self, vector_id: int) -> bool:
        """Tombstone an id. Returns False when it was already deleted."""
        with self._write_mu, self._rw.write():
            slot = self.id_to_slot.get(vector_id)
            if slot is None:
                raise ScintireteError(
                    ErrorCode.VECTOR_NOT_FOUND, f"vector not found: {vector_id}"
                )
            return host_algo.delete(self.store, slot)

    def contains(self, vector_id: int) -> bool:
        with self._rw.read():
            slot = self.id_to_slot.get(vector_id)
            return slot is not None and not self.store.deleted[slot]

    def has_id(self, vector_id: int) -> bool:
        """True if the id was ever assigned (tombstoned ids included)."""
        with self._rw.read():
            return vector_id in self.id_to_slot

    def get_vector(self, vector_id: int) -> np.ndarray:
        with self._rw.read():
            slot = self.id_to_slot.get(vector_id)
            if slot is None or self.store.deleted[slot]:
                raise ScintireteError(
                    ErrorCode.VECTOR_NOT_FOUND, f"vector not found: {vector_id}"
                )
            return self.store.vectors[slot].copy()

    # ----- search -----

    def _check_queries(self, queries) -> np.ndarray:
        queries = np.asarray(queries, np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.store.dim:
            raise dimension_mismatch(self.store.dim, int(queries.shape[-1]))
        return queries

    def _on_device(self) -> bool:
        return self.use_device and self.store.live >= self.device_search_min_size

    def search(
        self, query: Sequence[float], params: SearchParams
    ) -> list[tuple[int, float]]:
        """Single query -> [(id, distance)] ascending."""
        return self.search_batch(
            np.asarray(query, np.float32)[None, :], params
        )[0]

    def search_batch(
        self, queries: np.ndarray, params: SearchParams
    ) -> list[list[tuple[int, float]]]:
        """Batched queries [B, dim] -> per-query [(id, distance)] ascending."""
        from scintirete_tpu_torch.index.results import assemble_results

        queries = self._check_queries(queries)
        with self._rw.read(span="index.lock"):
            if self.store.live == 0:
                return [[] for _ in range(queries.shape[0])]
            slots_b, dists_b = self._search_slots(queries, params)
            with trace.span("index.assemble"):
                return assemble_results(self.slot_to_id, slots_b, dists_b)

    def search_batch_arrays(
        self, queries: np.ndarray, params: SearchParams
    ) -> tuple[np.ndarray, np.ndarray]:
        """Packed-array search: (ids u64 [B,k], dists f32 [B,k]); id 0 /
        +inf mark missing hits."""
        from scintirete_tpu_torch.index.results import assemble_arrays

        queries = self._check_queries(queries)
        with self._rw.read(span="index.lock"):
            if self.store.live == 0:
                b = queries.shape[0]
                return (np.zeros((b, 0), np.uint64),
                        np.zeros((b, 0), np.float32))
            slots_b, dists_b = self._search_slots(queries, params)
            with trace.span("index.assemble"):
                return assemble_arrays(self.slot_to_id, slots_b, dists_b)

    def search_submit(self, queries: np.ndarray, params: SearchParams):
        """Run a batched search leaving its results on the device; pair
        with search_collect."""
        queries = self._check_queries(queries)
        with self._rw.read():
            if self.store.live == 0 or not self._on_device():
                return ("done", self.search_batch(queries, params))
            ef = params.ef_search or self.store.params.ef_search
            return (
                "dev",
                self._get_device().search_submit(
                    self.store, queries, params.top_k, max(ef, params.top_k),
                    **self._search_args(),
                ),
            )

    def search_collect(self, pending) -> list[list[tuple[int, float]]]:
        from scintirete_tpu_torch.index.results import assemble_results

        kind, payload = pending
        if kind == "done":
            return payload
        with self._rw.read():
            slots_b, dists_b = self._get_device().search_collect(payload)
            return assemble_results(self.slot_to_id, slots_b, dists_b)

    def search_batch_pipelined(
        self, batches, params: SearchParams, depth: int = 2
    ) -> list[list[list[tuple[int, float]]]]:
        """Search several query batches keeping up to `depth` submitted
        before collecting."""
        from collections import deque

        out = []
        pending: deque = deque()
        for q in batches:
            pending.append(self.search_submit(q, params))
            if len(pending) >= depth:
                out.append(self.search_collect(pending.popleft()))
        while pending:
            out.append(self.search_collect(pending.popleft()))
        return out

    def _search_slots(self, queries, params):
        if self._on_device():
            ef = params.ef_search if params.ef_search else self.store.params.ef_search
            ef = max(ef, params.top_k)
            return self._get_device().search(
                self.store, queries, params.top_k, ef, **self._search_args()
            )
        return self._host_search(queries, params)

    def _search_args(self) -> dict:
        return {"entry_mode": self.entry_mode, "ef_upper": self.ef_upper,
                "descent_mid": self.descent_mid}

    def _host_search(self, queries, params):
        slots_b, dists_b = [], []
        k = params.top_k
        for q in queries:
            slots, dists = host_algo.search(self.store, q, k, params.ef_search)
            pad = k - slots.shape[0]
            if pad > 0:
                slots = np.concatenate([slots, np.full(pad, -1, np.int64)])
                dists = np.concatenate([dists, np.full(pad, np.inf, np.float32)])
            slots_b.append(slots)
            dists_b.append(dists)
        return np.stack(slots_b), np.stack(dists_b)

    def _get_device(self):
        from scintirete_tpu_torch.index.device import DeviceIndex

        if self._device is None:
            self._device = DeviceIndex(
                self.device, dtype=self.device_dtype,
                max_batch=self.search_batch_size,
            )
        return self._device

    # ----- graph state export/import (same dict as the JAX package) -----

    def export_graph_state(self) -> dict[str, Any]:
        """Snapshot of the full graph; restoring it needs no rebuild. The
        dict has the keys and dtypes of the JAX package's, so a graph
        crosses between the two packages either way."""
        with self._rw.read():
            s = self.store
            n = s.count
            return {
                "dim": s.dim,
                "metric": int(s.metric),
                "params": dataclasses.asdict(s.params),
                "count": n,
                "live": s.live,
                "entry_slot": s.entry_slot,
                "max_layer": s.max_layer,
                "vectors": s.vectors[:n].copy(),
                "levels": s.levels[:n].copy(),
                "deleted": s.deleted[:n].copy(),
                "neighbors0": s.neighbors0[:n].copy(),
                "layers": [
                    {
                        "count": ls.count,
                        "node_slot": ls.node_slot[: ls.count].copy(),
                        "nbrs": ls.nbrs[: ls.count].copy(),
                    }
                    for ls in s.layers
                ],
                "slot_to_id": self.slot_to_id[:n].copy(),
            }

    @classmethod
    def import_graph_state(
        cls,
        state: dict[str, Any],
        device_dtype: str = "float32",
        use_device: bool = True,
        **kw: Any,
    ) -> "HNSWIndex":
        """Restore without rebuild. `kw` forwards `device` and the serving
        knobs (search_batch_size, build_chunk_size, device_search_min_size)."""
        params = HNSWParams(**state["params"])
        idx = cls(
            dim=state["dim"],
            params=params,
            metric=DistanceMetric(state["metric"]),
            device_dtype=device_dtype,
            use_device=use_device,
            **kw,
        )
        s = idx.store
        n = int(state["count"])
        while s.cap < max(n, 1):
            s._grow()
        s.count = n
        s.live = int(state["live"])
        s.entry_slot = int(state["entry_slot"])
        s.max_layer = int(state["max_layer"])
        s.vectors[:n] = state["vectors"]
        s.levels[:n] = state["levels"]
        s.deleted[:n] = state["deleted"]
        s.neighbors0[:n] = state["neighbors0"]
        s.layers = []
        for ldata in state["layers"]:
            ls = LayerStore(s.m, s.cap)
            cnt = int(ldata["count"])
            while ls.cap < max(cnt, 1):
                ls.cap *= 2
            ls.node_slot = np.full(ls.cap, -1, np.int32)
            ls.nbrs = np.full((ls.cap, s.m), -1, np.int32)
            ls.node_slot[:cnt] = ldata["node_slot"]
            ls.nbrs[:cnt] = ldata["nbrs"]
            ls.count = cnt
            rows = np.arange(cnt, dtype=np.int32)
            ls.row_of[ldata["node_slot"][:cnt]] = rows
            s.layers.append(ls)
        s.linked_count = n
        slot_to_id = np.asarray(state["slot_to_id"], np.uint64)
        idx.slot_to_id = np.zeros(s.cap, np.uint64)
        idx.slot_to_id[:n] = slot_to_id
        for slot in range(n):
            if s.levels[slot] >= 0:
                idx.id_to_slot[int(slot_to_id[slot])] = slot
        s.version += 1
        return idx
